"""absgrad (AbsGS / gsplat absgrad) densification-statistic tests.

The statistic is the per-gaussian sum over tiles of |dL/dmeans2d restricted
to that tile's pixels| (ops/raster_pallas._gather_rows_abs). Oracle: render
with the XLA path under tile-masked losses — the gradient of the loss
restricted to one tile's pixels IS that tile's slot gradient — and sum the
absolute values over tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax import train as mtrain

CFG_KW = dict(tile_capacity=128, chunk_size=64, max_tile_span=4)
CFG_XLA = RenderConfig(**CFG_KW)
CFG_PALLAS = RenderConfig(**CFG_KW, raster_impl="pallas",
                          pallas_interpret=True)


def make_scene(n=60, seed=2):
    params = mtrain.activate(
        mtrain.init_gaussians(jax.random.PRNGKey(seed), n, position_scale=1.0)
    )
    camera = Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=32, W=48,
        fx=40.0, fy=40.0, cx=24.0, cy=16.0,
    )
    return params, camera


def weighted_loss(img, w):
    return jnp.sum(img * w)


def render(config, params, camera, offset=None, sink=None):
    return render_gaussians(
        params["means3d"], params["scales"], params["quats"],
        params["opacities"], params["features"], camera,
        config=config, means2d_offset=offset, absgrad_sink=sink,
    )


def test_absgrad_matches_tile_masked_oracle():
    params, camera = make_scene()
    n = params["means3d"].shape[0]
    w = jax.random.normal(jax.random.PRNGKey(7), (32, 48, 3))

    sink0 = jnp.zeros((n, 2))
    absg = jax.grad(
        lambda s: weighted_loss(render(CFG_PALLAS, params, camera, sink=s), w)
    )(sink0)

    # Oracle: per-tile masked losses through the XLA path.
    ts = CFG_XLA.tile_size
    offset0 = jnp.zeros((n, 2))
    expected = np.zeros((n, 2), np.float32)
    for ty in range(0, 32, ts):
        for tx in range(0, 48, ts):
            mask = np.zeros((32, 48, 3), np.float32)
            mask[ty : ty + ts, tx : tx + ts] = 1.0
            g = jax.grad(
                lambda o: weighted_loss(
                    render(CFG_XLA, params, camera, offset=o),
                    w * jnp.asarray(mask),
                )
            )(offset0)
            expected += np.abs(np.asarray(g))

    np.testing.assert_allclose(np.asarray(absg), expected, rtol=2e-3,
                               atol=1e-5)
    # absgrad dominates the signed gradient component-wise.
    signed = jax.grad(
        lambda o: weighted_loss(
            render(CFG_PALLAS, params, camera, offset=o), w
        )
    )(offset0)
    assert np.all(np.asarray(absg) >= np.abs(np.asarray(signed)) - 1e-5)


def test_absgrad_sink_does_not_change_forward_or_param_grads():
    params, camera = make_scene(n=40, seed=5)
    n = 40
    sink0 = jnp.zeros((n, 2))
    img_plain = render(CFG_PALLAS, params, camera)
    img_sink = render(CFG_PALLAS, params, camera, sink=sink0)
    np.testing.assert_array_equal(np.asarray(img_plain), np.asarray(img_sink))

    def loss_plain(m):
        p = dict(params, means3d=m)
        return jnp.sum(render(CFG_PALLAS, p, camera) ** 2)

    def loss_sink(m):
        p = dict(params, means3d=m)
        return jnp.sum(render(CFG_PALLAS, p, camera, sink=sink0) ** 2)

    g_plain = jax.grad(loss_plain)(params["means3d"])
    g_sink = jax.grad(loss_sink)(params["means3d"])
    np.testing.assert_allclose(
        np.asarray(g_plain), np.asarray(g_sink), rtol=1e-6, atol=1e-8
    )


def test_absgrad_pallas_matches_xla_directly():
    """The production Pallas statistic vs the same-API XLA route (the tap in
    ops/rasterization._abs_tap) — no masked-loss scaffolding needed."""
    params, camera = make_scene(n=80, seed=11)
    n = params["means3d"].shape[0]
    w = jax.random.normal(jax.random.PRNGKey(3), (32, 48, 3))
    sink0 = jnp.zeros((n, 2))

    def absg(config):
        return jax.grad(
            lambda s: weighted_loss(
                render(config, params, camera, sink=s), w
            )
        )(sink0)

    np.testing.assert_allclose(
        np.asarray(absg(CFG_PALLAS)), np.asarray(absg(CFG_XLA)),
        rtol=2e-3, atol=1e-5,
    )


def test_absgrad_xla_sink_does_not_change_forward():
    params, camera = make_scene(n=30, seed=9)
    sink0 = jnp.zeros((30, 2))
    img_plain = render(CFG_XLA, params, camera)
    img_sink = render(CFG_XLA, params, camera, sink=sink0)
    np.testing.assert_array_equal(np.asarray(img_plain), np.asarray(img_sink))


def test_train_step_with_densify_stats_absgrad():
    from mojosplat_jax.densify import DensifyState

    n = 40
    raw = mtrain.init_gaussians(jax.random.PRNGKey(0), n, position_scale=1.0)
    import optax

    opt = optax.adam(1e-3)
    state = mtrain.TrainState(
        params=raw, opt_state=opt.init(raw), step=jnp.zeros((), jnp.int32)
    )
    camera = Camera.create(
        R=jnp.eye(3)[None], T=jnp.zeros((1, 3)), H=32, W=48,
        fx=jnp.full((1,), 40.0), fy=jnp.full((1,), 40.0),
        cx=jnp.full((1,), 24.0), cy=jnp.full((1,), 16.0),
        near=jnp.full((1,), 0.1), far=jnp.full((1,), 100.0),
    )
    targets = jnp.zeros((1, 32, 48, 3))
    dstate = DensifyState.zero(n)
    new_state, new_dstate, loss = mtrain.train_step_with_densify_stats(
        state, dstate, camera, targets, opt, config=CFG_PALLAS, absgrad=True
    )
    assert np.isfinite(float(loss))
    acc = np.asarray(new_dstate.grad_accum)
    assert np.all(np.isfinite(acc)) and acc.max() > 0
