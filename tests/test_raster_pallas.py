"""Pallas kernel parity tests (interpreter mode, CPU).

The GPU rasterizer kernels (ops/raster_triton.py, Pallas on the Triton
route) are the production rasterization path; the pure-XLA implementation
is the oracle (the role gsplat plays for the reference, SURVEY.md section
4). These tests run the kernels through the Pallas interpreter so they
execute anywhere, mirroring the reference's mojo-vs-gsplat parity tests
(tests/test_rasterization.py:91-146 there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax import train as mtrain
from mojosplat_jax.ops.raster_triton import pixel_blocking, raster_tiles

CFG_KW = dict(tile_capacity=128, chunk_size=64, max_tile_span=4)
CFG_XLA = RenderConfig(**CFG_KW)
CFG_PALLAS = RenderConfig(**CFG_KW, raster_impl="pallas",
                          pallas_interpret=True)


def make_scene(n=120, seed=0):
    params = mtrain.activate(
        mtrain.init_gaussians(jax.random.PRNGKey(seed), n, position_scale=1.0)
    )
    camera = Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=32, W=48,
        fx=40.0, fy=40.0, cx=24.0, cy=16.0,
    )
    return params, camera


def render(config, params, camera, bg=(0.2, 0.1, 0.3)):
    return render_gaussians(
        params["means3d"], params["scales"], params["quats"],
        params["opacities"], params["features"], camera,
        background_color=jnp.array(bg), config=config,
    )


class TestPallasVsXla:
    """Cross-implementation parity: XLA path is the oracle."""

    def test_forward_image_close(self):
        params, camera = make_scene()
        ix = render(CFG_XLA, params, camera)
        ip = render(CFG_PALLAS, params, camera)
        assert ix.shape == ip.shape == (32, 48, 3)
        assert jnp.max(jnp.abs(ix - ip)) < 1e-5

    def test_gradients_close(self):
        params, camera = make_scene()

        def loss(p, config):
            return jnp.mean(render(config, p, camera) ** 2)

        gx = jax.grad(lambda p: loss(p, CFG_XLA))(params)
        gp = jax.grad(lambda p: loss(p, CFG_PALLAS))(params)
        for k in gx:
            ref = jnp.max(jnp.abs(gx[k])) + 1e-12
            diff = jnp.max(jnp.abs(gx[k] - gp[k]))
            assert diff / ref < 1e-4, f"grad {k}: {diff} vs scale {ref}"

    def test_empty_scene_is_background(self):
        params, camera = make_scene(n=4)
        params = dict(params)
        params["means3d"] = jnp.full_like(params["means3d"], -100.0)
        img = render(CFG_PALLAS, params, camera)
        assert jnp.allclose(img[..., 0], 0.2, atol=1e-6)
        assert jnp.allclose(img[..., 1], 0.1, atol=1e-6)
        assert jnp.allclose(img[..., 2], 0.3, atol=1e-6)

    @pytest.mark.parametrize("tile_size", [8, 32])
    def test_other_tile_sizes_close(self, tile_size):
        # 8 px: one 64-pixel program per tile; 32 px: four 256-pixel
        # programs per tile whose per-slot gradient rows are summed.
        params, camera = make_scene(n=90, seed=5)
        kw = dict(CFG_KW, tile_size=tile_size)
        cfg_x = RenderConfig(**kw)
        cfg_p = RenderConfig(**kw, raster_impl="pallas",
                             pallas_interpret=True)
        ix = render(cfg_x, params, camera)
        ip = render(cfg_p, params, camera)
        assert jnp.max(jnp.abs(ix - ip)) < 1e-5

        def loss(p, config):
            return jnp.mean(render(config, p, camera) ** 2)

        gx = jax.grad(lambda p: loss(p, cfg_x))(params)
        gp = jax.grad(lambda p: loss(p, cfg_p))(params)
        for k in gx:
            ref = jnp.max(jnp.abs(gx[k])) + 1e-12
            diff = jnp.max(jnp.abs(gx[k] - gp[k]))
            assert diff / ref < 1e-4, f"grad {k}: {diff} vs scale {ref}"

    def test_early_termination_matches(self):
        # Opaque front gaussian saturates transmittance: the chunk-level
        # early exit must reproduce the sequential break exactly.
        params, camera = make_scene(n=60, seed=3)
        params = dict(params)
        params["opacities"] = jnp.full_like(params["opacities"], 0.999)
        ix = render(CFG_XLA, params, camera)
        ip = render(CFG_PALLAS, params, camera)
        assert jnp.max(jnp.abs(ix - ip)) < 1e-5


class TestConfigValidation:
    def test_bad_impl_raises(self):
        params, camera = make_scene(n=4)
        with pytest.raises(ValueError, match="raster_impl"):
            render(RenderConfig(raster_impl="cuda"), params, camera)

    def test_capacity_chunk_mismatch_raises(self):
        # The kernels consume slots in chunks of 16.
        params, camera = make_scene(n=4)
        cfg = RenderConfig(
            tile_capacity=24, chunk_size=8,
            raster_impl="pallas", pallas_interpret=True,
        )
        with pytest.raises(ValueError, match="multiple of 16"):
            render(cfg, params, camera)


@pytest.mark.parametrize(
    "tile_size, expected",
    [(8, (64, 1)), (16, (256, 1)), (32, (256, 4)), (12, (256, 1))],
)
def test_pixel_blocking(tile_size, expected):
    # Programs hold a power-of-two pixel block of at most 256 pixels; a
    # 12-px tile pads its 144 pixels to one 256-pixel block.
    pb, n_sub = pixel_blocking(tile_size)
    assert (pb, n_sub) == expected
    assert pb * n_sub >= tile_size * tile_size


def _blend_reference(pdata, counts, ts, tw, config):
    """Sequential per-pixel front-to-back blend of each tile's slots, the
    reference kernel's loop (rasterization.mojo:138-157) in plain jnp."""
    n_tiles = counts.shape[0]
    cap = pdata.shape[1] // n_tiles
    C = pdata.shape[0] - 6
    p = jnp.arange(ts * ts)
    accs, tfins = [], []
    for t in range(n_tiles):
        px = (t % tw) * ts + p % ts + 0.5
        py = (t // tw) * ts + p // ts + 0.5
        T = jnp.ones((ts * ts,))
        done = jnp.zeros((ts * ts,), bool)
        acc = jnp.zeros((C, ts * ts))
        for j in range(int(counts[t])):
            g = pdata[:, t * cap + j]
            dx, dy = g[0] - px, g[1] - py
            sigma = 0.5 * (g[2] * dx * dx + g[4] * dy * dy) + g[3] * dx * dy
            alpha = jnp.minimum(g[5] * jnp.exp(-sigma), config.max_alpha)
            ok = (sigma >= 0) & (alpha >= config.alpha_threshold) & ~done
            nxt = T * (1.0 - alpha)
            stop = ok & (nxt <= config.transmittance_eps)
            use = ok & ~stop
            acc = acc + jnp.where(use, alpha * T, 0.0) * g[6:, None]
            T = jnp.where(use, nxt, T)
            done = done | stop
        accs.append(acc)
        tfins.append(T)
    return jnp.stack(accs), jnp.stack(tfins)


@pytest.mark.parametrize("case", ["partial", "empty_tiles", "saturating"])
def test_raster_tiles_vjp_matches_sequential_reference(case):
    """The kernels' custom VJP against autodiff of the sequential loop."""
    ts, tw, n_tiles, cap, C = 8, 2, 4, 32, 3
    rng = np.random.default_rng(["partial", "empty_tiles",
                                 "saturating"].index(case))
    M = n_tiles * cap
    t_of = np.repeat(np.arange(n_tiles), cap)
    x = (t_of % tw) * ts + rng.uniform(-2, ts + 2, M)
    y = (t_of // tw) * ts + rng.uniform(-2, ts + 2, M)
    a = rng.uniform(0.05, 0.4, M)
    c = rng.uniform(0.05, 0.4, M)
    b = rng.uniform(-0.5, 0.5, M) * np.sqrt(a * c)
    op = rng.uniform(0.9, 0.999, M) if case == "saturating" else (
        rng.uniform(0.05, 0.8, M))
    cols = rng.uniform(0, 1, (C, M))
    pdata = jnp.asarray(np.vstack([x, y, a, b, c, op, cols]), jnp.float32)
    counts = {"partial": [32, 17, 5, 30], "empty_tiles": [0, 20, 0, 1],
              "saturating": [32, 32, 32, 9]}[case]
    counts = jnp.asarray(counts, jnp.int32)
    cfg = RenderConfig(tile_size=ts, pallas_interpret=True)
    wa = jnp.asarray(rng.normal(size=(n_tiles, C, ts * ts)), jnp.float32)
    wt = jnp.asarray(rng.normal(size=(n_tiles, ts * ts)), jnp.float32)

    def loss_kernel(pd):
        acc, tfin = raster_tiles(pd, counts, ts, tw, cfg)
        return jnp.sum(acc * wa) + jnp.sum(tfin * wt)

    def loss_ref(pd):
        acc, tfin = _blend_reference(pd, counts, ts, tw, cfg)
        return jnp.sum(acc * wa) + jnp.sum(tfin * wt)

    acc, tfin = raster_tiles(pdata, counts, ts, tw, cfg)
    acc_r, tfin_r = _blend_reference(pdata, counts, ts, tw, cfg)
    np.testing.assert_allclose(np.asarray(acc), np.asarray(acc_r),
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(tfin), np.asarray(tfin_r),
                               rtol=1e-5, atol=1e-7)
    g = np.asarray(jax.grad(loss_kernel)(pdata))
    g_r = np.asarray(jax.grad(loss_ref)(pdata))
    # Slots at or past a tile's count get exactly zero gradient.
    for t in range(n_tiles):
        assert not g[:, t * cap + int(counts[t]):(t + 1) * cap].any()
    scale = np.abs(g_r).max(axis=1, keepdims=True) + 1e-12
    assert (np.abs(g - g_r) / scale).max() < 1e-4


def test_nd_feature_channels_parity():
    # gsplat-style N-D channel rendering: the kernels blend arbitrary
    # per-gaussian channel vectors (feature splatting), not just rgb+aux.
    import jax.numpy as jnp
    import numpy as np

    params, camera = make_scene(n=100, seed=3)
    C = 9
    feats = jax.random.normal(jax.random.PRNGKey(8), (100, C)) * 0.3
    bg = jnp.linspace(0.0, 1.0, C)

    def render_feats(config, f):
        return render_gaussians(
            params["means3d"], params["scales"], params["quats"],
            params["opacities"], f, camera, background_color=bg,
            config=config,
        )

    img_x = render_feats(CFG_XLA, feats)
    img_p = render_feats(CFG_PALLAS, feats)
    assert img_p.shape == (32, 48, C)
    np.testing.assert_allclose(
        np.asarray(img_p), np.asarray(img_x), atol=3e-5
    )

    gx = jax.grad(lambda f: jnp.mean(render_feats(CFG_XLA, f) ** 2))(feats)
    gp = jax.grad(lambda f: jnp.mean(render_feats(CFG_PALLAS, f) ** 2))(
        feats
    )
    np.testing.assert_allclose(
        np.asarray(gp), np.asarray(gx), rtol=1e-4, atol=1e-7
    )
