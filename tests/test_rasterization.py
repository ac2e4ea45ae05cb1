"""Rasterization stage tests.

Strategy mirrors the reference (/root/reference/tests/test_rasterization.py):
parity against an oracle with projection+binning pinned identical for both
sides (:39-47), plus property tests (red center pixel :154-175, empty scene
background :177-196, opacity monotonicity :198-220, depth-order compositing
:222-248, nonzero background = T-weighted blend :112-129). Our oracles:

  1. A sequential per-pixel numpy rasterizer implementing the exact mojo
     kernel loop (rasterization.mojo:138-162) — skip tests, 0.999 cap,
     next_T <= 1e-4 break, background weighted by final T.
  2. ``rasterize_dense_oracle`` — the analytic-membership JAX oracle.

Tolerance: atol/rtol 1e-4, matching the reference's parity bar
(test_rasterization.py:110).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mojosplat_jax import Camera, RenderConfig
from mojosplat_jax.ops.binning import bin_gaussians_to_tiles
from mojosplat_jax.ops.projection import project_gaussians
from mojosplat_jax.ops.rasterization import (
    rasterize_dense_oracle,
    rasterize_gaussians,
)

CFG = RenderConfig(tile_capacity=128, chunk_size=32)


def make_camera(H=64, W=64, fx=100.0):
    return Camera.create(
        R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
        H=H, W=W, fx=fx, fy=fx, cx=W / 2, cy=H / 2,
    )


def make_scene(n, seed=0, C=3):
    rng = np.random.default_rng(seed)
    means = np.concatenate(
        [rng.normal(0, 0.4, (n, 2)), rng.uniform(1.5, 5.0, (n, 1))], axis=1
    ).astype(np.float32)
    log_scales = rng.normal(-1.8, 0.2, (n, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.5, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, C)).astype(np.float32)
    return map(jnp.asarray, (means, log_scales, quats, opac, colors))


def project_and_bin(means, log_scales, quats, opac, cam, cfg=CFG):
    proj = project_gaussians(means, log_scales, quats, opac, cam, cfg)
    binning = bin_gaussians_to_tiles(
        proj.means2d, proj.radii, proj.depths, cam.H, cam.W, cfg
    )
    return proj, binning


def numpy_sequential_rasterize(
    means2d, conics, colors, opac, bg, gids, tile_ranges, H, W, cfg=CFG
):
    """Literal transcription of the reference kernel's per-pixel loop
    (rasterization.mojo:88-162)."""
    means2d, conics, colors, opac, bg = map(
        np.asarray, (means2d, conics, colors, opac, bg)
    )
    gids = np.asarray(gids)
    ranges = np.asarray(tile_ranges)
    th, tw = ranges.shape[:2]
    ts = cfg.tile_size
    C = colors.shape[-1]
    out = np.zeros((H, W, C), np.float64)
    for i in range(H):
        for j in range(W):
            ty, tx = i // ts, j // ts
            s, e = ranges[ty, tx]
            T = 1.0
            pix = np.zeros(C, np.float64)
            px, py = j + 0.5, i + 0.5
            for idx in range(s, e):
                g = gids[idx]
                if g < 0:
                    continue
                dx = means2d[g, 0] - px
                dy = means2d[g, 1] - py
                a, b, c = conics[g]
                sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
                alpha = min(opac[g] * np.exp(-sigma), cfg.max_alpha)
                if sigma < 0 or alpha < cfg.alpha_threshold:
                    continue
                next_T = T * (1 - alpha)
                if next_T <= cfg.transmittance_eps:
                    break
                pix += colors[g] * alpha * T
                T = next_T
            out[i, j] = pix + T * bg
    return out


@pytest.mark.parametrize("n", [1, 5, 50, 200])
@pytest.mark.parametrize("bg_val", [0.0, 0.25])
def test_parity_vs_sequential_numpy(n, bg_val):
    # Reference parity test shape: N in {1,5,50,200}, zero and nonzero
    # backgrounds (test_rasterization.py:94,112-129).
    cam = make_camera()
    means, log_scales, quats, opac, colors = make_scene(n, seed=n)
    bg = jnp.full((3,), bg_val, jnp.float32)
    proj, binning = project_and_bin(means, log_scales, quats, opac, cam)
    img, aux = rasterize_gaussians(
        proj.means2d, proj.conics, colors, opac, bg, binning, cam.H, cam.W, CFG
    )
    assert int(aux.tile_overflow) == 0
    ref = numpy_sequential_rasterize(
        proj.means2d, proj.conics, colors, opac, bg,
        binning.gaussian_ids, binning.tile_ranges, cam.H, cam.W,
    )
    np.testing.assert_allclose(np.asarray(img), ref, atol=1e-4, rtol=1e-4)


def test_parity_tiled_vs_dense_oracle():
    cam = make_camera(H=48, W=80)  # non-square, W not multiple of 16 -> crop
    means, log_scales, quats, opac, colors = make_scene(80, seed=7)
    bg = jnp.array([0.1, 0.2, 0.3], jnp.float32)
    proj, binning = project_and_bin(means, log_scales, quats, opac, cam)
    img, _ = rasterize_gaussians(
        proj.means2d, proj.conics, colors, opac, bg, binning, cam.H, cam.W, CFG
    )
    oracle = rasterize_dense_oracle(
        proj.means2d, proj.conics, colors, opac, bg, proj.depths, proj.radii,
        cam.H, cam.W, CFG,
    )
    np.testing.assert_allclose(np.asarray(img), np.asarray(oracle), atol=1e-4,
                               rtol=1e-4)


def _full_render(means, log_scales, quats, opac, colors, cam, bg, cfg=CFG):
    proj, binning = project_and_bin(means, log_scales, quats, opac, cam, cfg)
    img, aux = rasterize_gaussians(
        proj.means2d, proj.conics, colors, opac, bg, binning, cam.H, cam.W, cfg
    )
    return img, aux


def test_centered_red_gaussian_red_center():
    # (test_rasterization.py:154-175)
    cam = make_camera()
    img, _ = _full_render(
        jnp.array([[0.0, 0.0, 2.0]]),
        jnp.full((1, 3), -1.5),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.95]),
        jnp.array([[1.0, 0.0, 0.0]]),
        cam,
        jnp.zeros(3),
    )
    center = np.asarray(img[cam.H // 2, cam.W // 2])
    assert center[0] > 0.5
    assert center[1] < 0.1 and center[2] < 0.1


def test_empty_scene_pure_background():
    # (test_rasterization.py:177-196) — and unlike the reference orchestrator's
    # special-case early return (render.py:73-76) this flows through the same
    # traced program.
    cam = make_camera()
    bg = jnp.array([0.3, 0.5, 0.7])
    img, _ = _full_render(
        jnp.array([[0.0, 0.0, -5.0]]),  # behind camera -> culled
        jnp.full((1, 3), -1.5),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.9]),
        jnp.array([[1.0, 1.0, 1.0]]),
        cam,
        bg,
    )
    np.testing.assert_allclose(
        np.asarray(img), np.broadcast_to(np.asarray(bg), img.shape), atol=1e-6
    )


def test_brightness_monotone_in_opacity():
    # (test_rasterization.py:198-220)
    cam = make_camera()
    vals = []
    for op in [0.1, 0.4, 0.8]:
        img, _ = _full_render(
            jnp.array([[0.0, 0.0, 2.0]]),
            jnp.full((1, 3), -1.5),
            jnp.array([[1.0, 0.0, 0.0, 0.0]]),
            jnp.array([op]),
            jnp.array([[1.0, 1.0, 1.0]]),
            cam,
            jnp.zeros(3),
        )
        vals.append(float(img[cam.H // 2, cam.W // 2, 0]))
    assert vals[0] < vals[1] < vals[2]


def test_depth_order_front_beats_back():
    # Front red vs back blue at the shared pixel (test_rasterization.py:222-248).
    cam = make_camera()
    img, _ = _full_render(
        jnp.array([[0.0, 0.0, 1.5], [0.0, 0.0, 4.0]]),
        jnp.full((2, 3), -1.5),
        jnp.tile(jnp.array([[1.0, 0.0, 0.0, 0.0]]), (2, 1)),
        jnp.array([0.9, 0.9]),
        jnp.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
        cam,
        jnp.zeros(3),
    )
    center = np.asarray(img[cam.H // 2, cam.W // 2])
    assert center[0] > center[2]


def test_background_weighted_by_final_transmittance():
    # out = accum + T * background (rasterization.mojo:160-162); corners where
    # nothing renders must equal the background exactly, and aux carries T.
    cam = make_camera()
    bg = jnp.array([0.25, 0.5, 0.75])
    img, aux = _full_render(
        jnp.array([[0.0, 0.0, 2.0]]),
        jnp.full((1, 3), -2.0),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.9]),
        jnp.array([[1.0, 1.0, 1.0]]),
        cam,
        bg,
    )
    np.testing.assert_allclose(np.asarray(img[0, 0]), np.asarray(bg), atol=1e-5)
    T = np.asarray(aux.final_transmittance)
    assert T.shape == (cam.H, cam.W)
    assert T[0, 0] > 0.999  # untouched corner
    assert T[cam.H // 2, cam.W // 2] < 0.2  # behind the opaque gaussian


def test_tile_capacity_overflow_counted():
    cfg = RenderConfig(tile_capacity=4, chunk_size=4)
    cam = make_camera()
    n = 10  # 10 gaussians into the same center tile, capacity 4
    means = jnp.concatenate(
        [jnp.zeros((n, 2)), jnp.linspace(1.5, 3.0, n)[:, None]], axis=1
    )
    img, aux = _full_render(
        means,
        jnp.full((n, 3), -2.5),
        jnp.tile(jnp.array([[1.0, 0.0, 0.0, 0.0]]), (n, 1)),
        jnp.full((n,), 0.6),
        jnp.ones((n, 3)),
        cam,
        jnp.zeros(3),
        cfg,
    )
    assert int(aux.tile_overflow) > 0


def test_jit_no_recompile_across_scenes():
    cam = make_camera()

    @jax.jit
    def render(m, s, q, o, c):
        proj, binning = project_and_bin(m, s, q, o, cam)
        img, _ = rasterize_gaussians(
            proj.means2d, proj.conics, c, o, jnp.zeros(3), binning,
            cam.H, cam.W, CFG,
        )
        return img

    a = make_scene(20, seed=1)
    render(*a).block_until_ready()
    n0 = render._cache_size()
    b = make_scene(20, seed=2)
    render(*b).block_until_ready()
    assert render._cache_size() == n0
