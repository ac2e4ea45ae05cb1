"""Tight contribution-aware intersection culling (binning.tight_cull).

The AABB tile test (shared with the reference,
/root/reference/mojosplat/binning.py:138-155) admits slots whose peak
alpha over the tile can never reach alpha_threshold — the blend kernels
zero them anyway. Tight culling removes them at emission: these tests pin
(a) image/gradient-neutrality vs the AABB route at ample budgets, (b) the
conservative guarantee (every culled slot really contributes zero —
checked against a brute-force per-pixel evaluation), (c) XLA/Pallas route
agreement under tight mode, and (d) improved slot retention under
capacity overflow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax import train as mtrain
from mojosplat_jax.ops.binning import (
    _MASK_BITS,
    _tight_tile_masks,
    bin_gaussians_to_tiles,
)


def make_camera(H=96, W=128):
    return Camera.create(
        R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
        H=H, W=W, fx=90.0, fy=90.0, cx=W / 2, cy=H / 2,
    )


def make_aniso_scene(n=400, seed=3):
    rng = np.random.default_rng(seed)
    raw = mtrain.init_gaussians(
        jax.random.PRNGKey(0), n, sh_degree=1, position_scale=1.0
    )
    raw["scales"] = raw["scales"] + jnp.asarray(
        np.stack(
            [rng.normal(1.0, 0.3, n), rng.normal(-1.5, 0.3, n),
             rng.normal(0, 0.1, n)], axis=1,
        ),
        jnp.float32,
    )
    return mtrain.activate(raw)


def config(tight, impl, **kw):
    base = dict(
        tile_size=16, tile_capacity=256, chunk_size=32, max_tile_span=8,
        isect_padding_multiplier=40, raster_impl=impl,
        pallas_interpret=(impl == "pallas"),
        tight_cull=tight,
    )
    base.update(kw)
    return RenderConfig(**base)


def render_with_grads(params, cam, cfg):
    def loss(p):
        img, aux = render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, sh_degree=1,
            background_color=jnp.array([0.1, 0.2, 0.3]),
            config=cfg, return_aux=True,
        )
        return jnp.mean(img ** 2), (img, aux)

    (_, (img, aux)), g = jax.value_and_grad(loss, has_aux=True)(params)
    return img, g, aux


def test_tight_neutral_and_culls():
    """At ample budgets tight culling changes nothing but the slot count."""
    cam = make_camera()
    params = make_aniso_scene()
    img_a, g_a, aux_a = render_with_grads(params, cam, config(False, "xla"))
    img_t, g_t, aux_t = render_with_grads(params, cam, config(True, "xla"))

    assert int(aux_a.binning.tight_culled) == 0
    culled = int(aux_t.binning.tight_culled)
    kept = int(aux_t.binning.num_isects)
    assert culled > 0, "anisotropic scene must cull some AABB slots"
    assert kept + culled == int(aux_a.binning.num_isects)
    # Only blend-order (chunk-boundary) noise may differ.
    np.testing.assert_allclose(np.asarray(img_a), np.asarray(img_t),
                               atol=2e-6)
    for k in g_a:
        np.testing.assert_allclose(np.asarray(g_a[k]), np.asarray(g_t[k]),
                                   atol=2e-6, err_msg=k)


def test_tight_routes_agree():
    cam = make_camera()
    params = make_aniso_scene(seed=5)
    img_x, g_x, aux_x = render_with_grads(params, cam, config(True, "xla"))
    img_p, g_p, aux_p = render_with_grads(params, cam,
                                          config(True, "pallas"))
    assert int(aux_x.binning.num_isects) == int(aux_p.binning.num_isects)
    np.testing.assert_allclose(np.asarray(img_x), np.asarray(img_p),
                               atol=1e-5)
    for k in g_x:
        scale = float(np.abs(np.asarray(g_x[k])).max()) + 1e-12
        np.testing.assert_allclose(
            np.asarray(g_p[k]) / scale, np.asarray(g_x[k]) / scale,
            atol=2e-5, err_msg=k,
        )


def test_culled_slots_truly_contribute_zero():
    """Brute force: every candidate tile the mask rejects has peak alpha
    below threshold at EVERY pixel center of that tile (the conservative
    guarantee that makes culling lossless)."""
    from mojosplat_jax.ops.projection import project_gaussians

    cam = make_camera()
    params = make_aniso_scene(n=120, seed=7)
    cfg = config(True, "xla")
    proj = project_gaussians(
        params["means3d"], params["scales"], params["quats"],
        params["opacities"], cam, cfg,
    )
    ts, span = cfg.tile_size, cfg.max_tile_span
    x, y = np.asarray(proj.means2d[:, 0]), np.asarray(proj.means2d[:, 1])
    radii = np.asarray(proj.radii)
    from mojosplat_jax.ops.binning import num_tiles

    th, tw = num_tiles(cam.H, cam.W, ts)
    tx_min = np.clip(np.floor((x - radii[:, 0]) / ts), 0, tw).astype(np.int32)
    tx_max = np.clip(np.ceil((x + radii[:, 0]) / ts), 0, tw).astype(np.int32)
    ty_min = np.clip(np.floor((y - radii[:, 1]) / ts), 0, th).astype(np.int32)
    ty_max = np.clip(np.ceil((y + radii[:, 1]) / ts), 0, th).astype(np.int32)
    valid = (radii[:, 0] > 0) & (radii[:, 1] > 0)
    span_x = np.where(valid, tx_max - tx_min, 0)
    span_y = np.where(valid, ty_max - ty_min, 0)
    ex_x = np.maximum(span_x - span, 0)
    ex_y = np.maximum(span_y - span, 0)
    tx_min = tx_min + ex_x // 2
    ty_min = ty_min + ex_y // 2
    span_x = np.minimum(span_x, span)
    span_y = np.minimum(span_y, span)

    counts, masks = _tight_tile_masks(
        proj.means2d, proj.conics, params["opacities"],
        jnp.asarray(tx_min), jnp.asarray(ty_min),
        jnp.asarray(span_x), jnp.asarray(span_y),
        ts, span, cfg.alpha_threshold,
    )
    masks = [np.asarray(m) for m in masks]
    conics = np.asarray(proj.conics)
    opac = np.asarray(params["opacities"])

    checked = 0
    for i in range(x.shape[0]):
        for j in range(span * span):
            ky, kx = divmod(j, span)
            if kx >= span_x[i] or ky >= span_y[i]:
                continue
            bit = (masks[j // _MASK_BITS][i] >> (j % _MASK_BITS)) & 1
            if bit:
                continue
            # Rejected candidate: evaluate alpha at every pixel center.
            px = (tx_min[i] + kx) * ts + np.arange(ts) + 0.5
            py = (ty_min[i] + ky) * ts + np.arange(ts) + 0.5
            dx = x[i] - px[None, :]
            dy = y[i] - py[:, None]
            a, b, c = conics[i]
            sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
            alpha = opac[i] * np.exp(-sigma)
            assert alpha.max() < cfg.alpha_threshold, (
                f"gaussian {i} candidate {j}: culled but peak alpha "
                f"{alpha.max()}"
            )
            checked += 1
    assert checked > 50, "scene produced too few rejected candidates"


def test_overflow_keeps_more_contributing_slots():
    """Under a tiny capacity, tight mode's kept slots are all contributing
    while AABB mode wastes budget on zero-contribution slots."""
    cam = make_camera()
    params = make_aniso_scene(seed=11)
    a_t = render_with_grads(params, cam,
                            config(True, "xla",
                                   isect_padding_multiplier=1))[2]
    a_a = render_with_grads(params, cam,
                            config(False, "xla",
                                   isect_padding_multiplier=1))[2]
    # Both clamp to the same capacity; tight mode's demand is smaller.
    demand_t = int(a_t.binning.num_isects) + int(a_t.binning.capacity_overflow)
    demand_a = int(a_a.binning.num_isects) + int(a_a.binning.capacity_overflow)
    assert demand_t < demand_a


def test_span_too_large_raises():
    cam = make_camera()
    params = make_aniso_scene(n=50)
    cfg = config(True, "xla", max_tile_span=16)
    with pytest.raises(ValueError, match="tight_cull"):
        render_gaussians(
            params["means3d"], params["scales"], params["quats"],
            params["opacities"], params["features"], cam, sh_degree=1,
            config=cfg,
        )


def test_surfel_path_ignores_tight_cull():
    """2DGS binning gets no conics, so tight_cull must silently no-op."""
    from mojosplat_jax.surfel import render_surfels

    cam = make_camera()
    params = make_aniso_scene(n=64)
    sp = dict(params)
    sp["scales"] = params["scales"][:, :2]
    cfg = config(True, "xla")
    img = render_surfels(
        sp["means3d"], sp["scales"], sp["quats"], sp["opacities"],
        sp["features"], cam, sh_degree=1,
        background_color=jnp.array([0.1, 0.2, 0.3]), config=cfg,
    )
    assert np.all(np.isfinite(np.asarray(img)))
