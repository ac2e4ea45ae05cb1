"""End-to-end test of the training CLI (examples/train_colmap.py) with the
per-view appearance modules enabled: build a synthetic COLMAP capture whose
target images carry a radial vignette the scene itself cannot explain, train
briefly with --bilagrid, and check the bilateral grids moved off identity
and all artifacts were written. Exercises the full CLI path (loader, padding
to capacity, jitted step with view-nuisance optimization, artifact save)."""

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
    W, H, f = 64, 48, 60.0

    with open(sparse / "cameras.bin", "wb") as fo:
        fo.write(struct.pack("<Q", 1))
        fo.write(struct.pack("<iiQQ", 1, 1, W, H))
        fo.write(struct.pack("<4d", f, f, W / 2, H / 2))
    views = [
        ("v0.png", (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
        ("v1.png", (1.0, 0.0, 0.0, 0.0), (0.1, 0.0, 0.0)),
    ]
    # SfM points: the cloud the trainer initializes from.
    rng = np.random.default_rng(3)
    n_pts = 120
    xyz = rng.normal(0, 0.4, (n_pts, 3)) + np.array([0.0, 0.0, 2.0])
    rgb = rng.integers(0, 256, (n_pts, 3))

    # Each view observes every point (identity R): pixel = f*xy/z + c.
    # These 2D observations feed --depth-loss via sparse_depth_targets.
    with open(sparse / "images.bin", "wb") as fo:
        fo.write(struct.pack("<Q", len(views)))
        for i, (name, q, t) in enumerate(views):
            fo.write(struct.pack("<i", i + 1))
            fo.write(struct.pack("<4d", *q))
            fo.write(struct.pack("<3d", *t))
            fo.write(struct.pack("<i", 1))
            fo.write(name.encode() + b"\x00")
            pc = xyz + np.asarray(t)
            us = f * pc[:, 0] / pc[:, 2] + W / 2
            vs = f * pc[:, 1] / pc[:, 2] + H / 2
            fo.write(struct.pack("<Q", n_pts))
            for j in range(n_pts):
                fo.write(struct.pack("<ddq", us[j], vs[j], j + 1))
    with open(sparse / "points3D.bin", "wb") as fo:
        fo.write(struct.pack("<Q", n_pts))
        for i in range(n_pts):
            fo.write(struct.pack("<Q", i + 1))
            fo.write(struct.pack("<3d", *xyz[i]))
            fo.write(struct.pack("<3B", *rgb[i]))
            fo.write(struct.pack("<d", 1.0))
            fo.write(struct.pack("<Q", 0))

    # Target images: renders of a known cloud, CORRUPTED by a radial
    # vignette — per-view photometric nuisance for the grid to absorb.
    raw = mtrain.init_gaussians(
        jax.random.PRNGKey(5), 200, sh_degree=0, position_scale=0.4
    )
    raw["means3d"] = raw["means3d"] + jnp.array([0.0, 0.0, 2.0])
    p = mtrain.activate(raw)
    cfg = RenderConfig(raster_impl="xla")
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, H), np.linspace(-1, 1, W), indexing="ij"
    )
    vignette = (1.0 - 0.35 * (xx**2 + yy**2)).astype(np.float32)
    for name, q, t in views:
        cam = Camera.create(
            R=jnp.asarray(qvec_to_rotmat(np.asarray(q)), jnp.float32),
            T=jnp.asarray(t, jnp.float32),
            H=H, W=W, fx=f, fy=f, cx=W / 2, cy=H / 2,
        )
        img = render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, sh_degree=0, config=cfg,
        )
        save_png(np.asarray(img) * vignette[..., None],
                 str(root / "images" / name))
    return root


def test_train_cli_with_bilagrid(capture, capsys):
    root = capture
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = str(root / "out")
    argv = sys.argv
    sys.argv = [
        "x", "--data", str(root), "--downscale", "1", "--steps", "25",
        "--impl", "xla", "--max-gaussians", "256", "--sh-degree", "0",
        "--bilagrid", "--bilagrid-lr", "5e-3", "--out-dir", out_dir,
        "--save-every", "0",
    ]
    try:
        import runpy

        runpy.run_path(
            os.path.join(repo, "examples", "train_colmap.py"),
            run_name="__main__",
        )
    finally:
        sys.argv = argv
    out = capsys.readouterr().out

    assert os.path.exists(os.path.join(out_dir, "scene_final.ply"))
    grids = np.load(os.path.join(out_dir, "bilateral_grids.npy"))
    assert grids.shape[0] == 2 and grids.shape[-1] == 12
    # The vignette is unexplainable by the scene: the grids must have
    # moved off identity, and training must report finite losses.
    ident = np.concatenate([np.eye(3).reshape(9), np.zeros(3)])
    dev = np.abs(grids - ident).mean()
    assert dev > 1e-4, f"grids stayed at identity (mean dev {dev})"
    assert "bilateral grids" in out


def test_train_cli_with_adc(capture, capsys):
    """--strategy adc: clone/split/prune density control driven by the
    accumulated view-space gradient statistic, inside the COLMAP trainer."""
    root = capture
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = str(root / "out_adc")
    argv = sys.argv
    sys.argv = [
        "x", "--data", str(root), "--downscale", "1", "--steps", "12",
        "--impl", "xla", "--max-gaussians", "256", "--sh-degree", "0",
        "--strategy", "adc", "--densify-every", "5",
        "--densify-grad-threshold", "1e-7", "--opacity-reset-every", "10",
        "--depth-loss", "0.05",
        "--out-dir", out_dir, "--save-every", "0",
    ]
    try:
        import runpy

        runpy.run_path(
            os.path.join(repo, "examples", "train_colmap.py"),
            run_name="__main__",
        )
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert os.path.exists(os.path.join(out_dir, "scene_final.ply"))
    assert "[densify:" in out and "[opacity reset]" in out
    assert "ADC scene extent" in out
    assert "depth supervision:" in out


def test_train_cli_2dgs(capture, capsys):
    """--primitive 2dgs: real-capture surfel training with the paper's
    depth-distortion + normal-consistency regularizers and MCMC density
    control; the saved PLY must carry the (N, 2) surfel-scale layout."""
    from mojosplat_jax.utils import load_gaussian_ply

    root = capture
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out_dir = str(root / "out_2dgs")
    argv = sys.argv
    sys.argv = [
        "x", "--data", str(root), "--downscale", "1", "--steps", "12",
        "--impl", "xla", "--max-gaussians", "256", "--sh-degree", "0",
        "--primitive", "2dgs", "--strategy", "mcmc",
        "--densify-every", "6", "--depth-loss", "0.05",
        "--out-dir", out_dir, "--save-every", "0",
    ]
    try:
        import runpy

        runpy.run_path(
            os.path.join(repo, "examples", "train_colmap.py"),
            run_name="__main__",
        )
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    ply = os.path.join(out_dir, "scene_final.ply")
    assert os.path.exists(ply)
    params = load_gaussian_ply(ply)
    assert params["scales"].shape[-1] == 2
    assert np.all(np.isfinite(params["means3d"]))
    assert "[mcmc:" in out
