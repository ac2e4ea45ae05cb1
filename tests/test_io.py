"""IO tests: native C extension vs pure-Python fallbacks, PLY round-trip,
PNG validity. Runs with or without a C toolchain (fallback paths are always
exercised)."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mojosplat_jax import train as mtrain
from mojosplat_jax.native import get_native
from mojosplat_jax.utils.image import save_png
from mojosplat_jax.utils.ply import (
    _read_ply_python,
    load_gaussian_ply,
    save_gaussian_ply,
)


@pytest.fixture(scope="module")
def scene():
    raw = mtrain.init_gaussians(jax.random.PRNGKey(7), 50, sh_degree=2)
    return {k: np.asarray(v) for k, v in raw.items()}


def test_ply_roundtrip(scene, tmp_path):
    path = str(tmp_path / "scene.ply")
    save_gaussian_ply(path, scene)
    back = load_gaussian_ply(path)
    for k in scene:
        np.testing.assert_allclose(
            back[k], scene[k], rtol=0, atol=1e-6, err_msg=k
        )


def test_ply_python_fallback_matches(scene, tmp_path):
    path = str(tmp_path / "scene.ply")
    save_gaussian_ply(path, scene)
    names_py, n_py, blob_py = _read_ply_python(path)
    native = get_native()
    if native is None:
        pytest.skip("no C toolchain; fallback already exercised")
    names_c, n_c, blob_c = native.load_ply(path)
    assert names_py == list(names_c)
    assert n_py == n_c
    assert blob_py == blob_c


def test_ply_rgb_features_saved_as_sh0(tmp_path):
    raw = mtrain.init_gaussians(jax.random.PRNGKey(1), 8, sh_degree=None)
    raw = {k: np.asarray(v) for k, v in raw.items()}
    path = str(tmp_path / "rgb.ply")
    save_gaussian_ply(path, raw)
    back = load_gaussian_ply(path)
    assert back["features"].shape == (8, 1, 3)
    # sh_to_color at degree 0 must reproduce the original RGB.
    from mojosplat_jax.ops.sh import sh_to_color

    col = sh_to_color(
        back["features"], back["means3d"], np.zeros(3), 0
    )
    np.testing.assert_allclose(col, raw["features"], atol=1e-6)


def test_ply_rejects_garbage(tmp_path):
    p = tmp_path / "bad.ply"
    p.write_bytes(b"not a ply at all")
    with pytest.raises(ValueError):
        _read_ply_python(str(p))


def test_png_decodable_by_pil(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((40, 60, 3)).astype(np.float32)
    path = str(tmp_path / "img.png")
    save_png(img, path)
    from PIL import Image

    back = np.asarray(Image.open(path))
    assert back.shape == (40, 60, 3)
    np.testing.assert_array_equal(
        back, (np.clip(img, 0, 1) * 255).astype(np.uint8)
    )


def test_png_native_matches_pil_bytes(tmp_path):
    native = get_native()
    if native is None:
        pytest.skip("no C toolchain")
    rng = np.random.default_rng(3)
    arr = (rng.random((16, 16, 4)) * 255).astype(np.uint8)
    path = str(tmp_path / "rgba.png")
    native.write_png(path, 16, 16, 4, arr.tobytes())
    from PIL import Image

    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back, arr)


# ---------------------------------------------------------------------------
# .splat web-viewer format
# ---------------------------------------------------------------------------

def test_splat_round_trip(tmp_path):
    from mojosplat_jax.utils.splat import (
        load_gaussian_splat,
        save_gaussian_splat,
    )

    p = mtrain.init_gaussians(jax.random.PRNGKey(2), 64, sh_degree=2)
    path = str(tmp_path / "scene.splat")
    save_gaussian_splat(path, p)
    assert os.path.getsize(path) == 64 * 32

    q = load_gaussian_splat(path)
    assert q["features"].shape == (64, 3)
    # Positions and linear scales are exact f32; match per-gaussian via
    # sorted order (the writer reorders by importance).
    a = np.asarray(p["means3d"])
    b = q["means3d"]
    a_sorted = a[np.lexsort(a.T)]
    b_sorted = b[np.lexsort(b.T)]
    np.testing.assert_allclose(b_sorted, a_sorted, rtol=1e-6)
    # Opacity round-trips through u8 within 1/255.
    po = np.sort(1 / (1 + np.exp(-np.asarray(p["opacities_raw"]))))
    qo = np.sort(1 / (1 + np.exp(-q["opacities_raw"])))
    np.testing.assert_allclose(qo, po, atol=1.5 / 255)


def test_splat_renders_like_source(tmp_path):
    # A saved+reloaded .splat must render close to the original scene
    # (u8 color/rotation quantization bounds the error).
    from mojosplat_jax import Camera, RenderConfig, render_gaussians
    from mojosplat_jax.utils.splat import (
        load_gaussian_splat,
        save_gaussian_splat,
    )

    p = mtrain.init_gaussians(jax.random.PRNGKey(4), 200, sh_degree=None,
                              position_scale=0.5)
    p["means3d"] = p["means3d"] + jnp.array([0.0, 0.0, 2.5])
    path = str(tmp_path / "s.splat")
    save_gaussian_splat(path, p)
    q = {k: jnp.asarray(v) for k, v in load_gaussian_splat(path).items()}

    cam = Camera.create(R=np.eye(3, dtype=np.float32),
                        T=np.zeros(3, np.float32), H=64, W=64,
                        fx=80.0, fy=80.0, cx=32.0, cy=32.0)
    cfg = RenderConfig(tile_capacity=128, chunk_size=32)

    def render(params):
        a = mtrain.activate(dict(params))
        return render_gaussians(
            a["means3d"], a["scales"], a["quats"], a["opacities"],
            a["features"], cam, config=cfg,
        )

    img_p = np.asarray(render(p))
    img_q = np.asarray(render(q))
    assert np.mean(np.abs(img_p - img_q)) < 0.02


def test_surfel_ply_round_trip(tmp_path):
    # 2DGS layout: two scale columns.
    from mojosplat_jax.utils.ply import load_gaussian_ply, save_gaussian_ply

    rng = np.random.default_rng(8)
    p = dict(
        means3d=rng.normal(size=(32, 3)).astype(np.float32),
        scales=rng.normal(size=(32, 2)).astype(np.float32),
        quats=rng.normal(size=(32, 4)).astype(np.float32),
        opacities_raw=rng.normal(size=(32,)).astype(np.float32),
        features=rng.uniform(size=(32, 3)).astype(np.float32),
    )
    path = str(tmp_path / "surfels.ply")
    save_gaussian_ply(path, p)
    q = load_gaussian_ply(path)
    assert q["scales"].shape == (32, 2)
    np.testing.assert_allclose(q["scales"], p["scales"], rtol=1e-6)
    np.testing.assert_allclose(q["means3d"], p["means3d"], rtol=1e-6)


def test_encode_png_roundtrip():
    # The in-memory PNG encoder behind the web viewer (examples/viewer.py).
    from PIL import Image
    import io as _io

    from mojosplat_jax.utils.image import encode_png

    rng = np.random.default_rng(4)
    arr = rng.integers(0, 255, (20, 31, 3), dtype=np.uint8)
    back = np.asarray(Image.open(_io.BytesIO(encode_png(arr))))
    np.testing.assert_array_equal(back, arr)
    gray = rng.integers(0, 255, (7, 9), dtype=np.uint8)
    back_g = np.asarray(Image.open(_io.BytesIO(encode_png(gray))))
    np.testing.assert_array_equal(back_g, gray)
