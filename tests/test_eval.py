"""End-to-end test of the evaluation harness (examples/eval_colmap.py):
build a synthetic COLMAP capture whose images are renders of a known cloud,
save that cloud as PLY, evaluate — PSNR must sit at the 8-bit PNG
quantization ceiling (~50 dB), proving loader, camera conversion, PLY
round-trip and renderer agree end-to-end."""

import json
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax import train as mtrain
from mojosplat_jax.utils import save_gaussian_ply, save_png
from mojosplat_jax.utils.colmap import qvec_to_rotmat


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    root = tmp_path_factory.mktemp("capture")
    (root / "images").mkdir()
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    W, H, f = 96, 64, 90.0

    with open(sparse / "cameras.bin", "wb") as fo:
        fo.write(struct.pack("<Q", 1))
        fo.write(struct.pack("<iiQQ", 1, 1, W, H))
        fo.write(struct.pack("<4d", f, f, W / 2, H / 2))
    views = [("v0.png", (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0))]
    with open(sparse / "images.bin", "wb") as fo:
        fo.write(struct.pack("<Q", len(views)))
        for i, (name, q, t) in enumerate(views):
            fo.write(struct.pack("<i", i + 1))
            fo.write(struct.pack("<4d", *q))
            fo.write(struct.pack("<3d", *t))
            fo.write(struct.pack("<i", 1))
            fo.write(name.encode() + b"\x00")
            fo.write(struct.pack("<Q", 0))
    with open(sparse / "points3D.bin", "wb") as fo:
        fo.write(struct.pack("<Q", 0))

    raw = mtrain.init_gaussians(
        jax.random.PRNGKey(5), 300, sh_degree=1, position_scale=0.5
    )
    raw["means3d"] = raw["means3d"] + jnp.array([0.0, 0.0, 2.5])
    p = mtrain.activate(raw)
    cfg = RenderConfig(raster_impl="xla")
    for name, q, t in views:
        cam = Camera.create(
            R=jnp.asarray(qvec_to_rotmat(np.asarray(q)), jnp.float32),
            T=jnp.asarray(t, jnp.float32),
            H=H, W=W, fx=f, fy=f, cx=W / 2, cy=H / 2,
        )
        img = render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, sh_degree=1, config=cfg,
        )
        save_png(img, str(root / "images" / name))
    ply = root / "scene.ply"
    save_gaussian_ply(str(ply), raw)
    return root, ply


def test_eval_harness_round_trip(capture, capsys):
    root, ply = capture
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "examples"))
    argv = sys.argv
    sys.argv = [
        "x", "--data", str(root), "--ply", str(ply),
        "--downscale", "1", "--every", "1", "--impl", "xla",
    ]
    try:
        import runpy

        runpy.run_path(
            os.path.join(repo, "examples", "eval_colmap.py"),
            run_name="__main__",
        )
    finally:
        sys.argv = argv
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["views"] == 1
    assert summary["mean_psnr"] > 45.0  # 8-bit PNG quantization ceiling
    assert summary["mean_ssim"] > 0.99


def test_eval_appearance_opt(capture, tmp_path, capsys):
    """Test-time appearance optimization (nerf-w protocol): on a capture
    whose ground truth carries a global color tint the scene cannot explain,
    the affine fitted on the left half must lift right-half PSNR well above
    the raw render's."""
    import shutil

    from PIL import Image

    root, ply = capture
    tinted_root = tmp_path / "tinted"
    shutil.copytree(root, tinted_root)
    for f in (tinted_root / "images").iterdir():
        img = np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
        tinted = np.clip(img * np.array([1.2, 0.8, 1.0]) + 0.03, 0, 1)
        Image.fromarray(
            (tinted * 255).round().astype(np.uint8)
        ).save(f)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(repo, "examples"))
    argv = sys.argv
    sys.argv = [
        "x", "--data", str(tinted_root), "--ply", str(ply),
        "--downscale", "1", "--every", "1", "--impl", "xla",
        "--appearance-opt", "affine", "--appearance-steps", "150",
        "--appearance-lr", "1e-2",
    ]
    try:
        import runpy

        runpy.run_path(
            os.path.join(repo, "examples", "eval_colmap.py"),
            run_name="__main__",
        )
    finally:
        sys.argv = argv
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert (summary["mean_psnr_right_corrected"]
            > summary["mean_psnr_right_raw"] + 3.0), summary
