"""Multi-device sharding tests on the 8-device virtual CPU mesh
(SURVEY.md section 4: multi-host logic tested via XLA-faked device counts).
The reference has nothing to mirror here — no distributed code exists in it
(SURVEY.md section 2.3)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax.parallel import (
    make_mesh,
    project_gaussians_sharded,
    render_batch_sharded,
)
from mojosplat_jax.ops.projection import project_gaussians
from mojosplat_jax import train as mtrain

CFG = RenderConfig(tile_capacity=64, chunk_size=32)


def batched_cameras(B, H=64, W=64, fx=80.0, seed=0):
    rng = np.random.default_rng(seed)
    Rs, Ts = [], []
    for _ in range(B):
        # Small random rotations + translations.
        a = rng.normal(0, 0.05)
        R = np.array(
            [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
            np.float32,
        )
        Rs.append(R)
        Ts.append(rng.normal(0, 0.05, 3).astype(np.float32))
    return Camera.create(
        R=np.stack(Rs),
        T=np.stack(Ts),
        H=H,
        W=W,
        fx=np.full(B, fx, np.float32),
        fy=np.full(B, fx, np.float32),
        cx=np.full(B, W / 2, np.float32),
        cy=np.full(B, H / 2, np.float32),
        near=np.full(B, 0.1, np.float32),
        far=np.full(B, 100.0, np.float32),
    )


def scene_params(n=64, seed=0, sh_degree=None):
    key = jax.random.PRNGKey(seed)
    p = mtrain.init_gaussians(key, n, sh_degree=sh_degree, position_scale=0.5)
    return p


def single_camera(cams, i):
    import dataclasses

    return dataclasses.replace(
        cams,
        R=cams.R[i], T=cams.T[i], fx=cams.fx[i], fy=cams.fy[i],
        cx=cams.cx[i], cy=cams.cy[i], near=cams.near[i], far=cams.far[i],
    )


def jit_render(render=render_gaussians, **kw):
    """Jitted single-camera render: an eager call dispatches every op."""
    return jax.jit(lambda p, cam: render(
        p["means3d"], p["scales"], p["quats"], p["opacities"],
        p["features"], cam, config=CFG, **kw,
    ))


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single_device():
    mesh = make_mesh(2, 4)
    B = 4
    cams = batched_cameras(B)
    raw = scene_params(48, seed=1)
    params = mtrain.activate(raw)

    sharded = jax.jit(lambda p, c: render_batch_sharded(
        p, c, mesh, config=CFG))(params, cams)
    sharded = np.asarray(sharded)
    assert sharded.shape == (B, 64, 64, 3)

    ref_fn = jit_render()
    for i in range(B):
        ref = ref_fn(params, single_camera(cams, i))
        np.testing.assert_allclose(sharded[i], np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_sharded_projection_matches_single_device():
    mesh = make_mesh(1, 8)
    cams = batched_cameras(1)
    cam = single_camera(cams, 0)
    raw = scene_params(64, seed=2)
    params = mtrain.activate(raw)
    a = jax.jit(lambda p, c: project_gaussians_sharded(
        p["means3d"], p["scales"], p["quats"], p["opacities"], c, mesh,
        config=CFG,
    ))(params, cam)
    b = jax.jit(lambda p, c: project_gaussians(
        p["means3d"], p["scales"], p["quats"], p["opacities"], c, CFG,
    ))(params, cam)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-6)


def test_sharded_train_step_matches_single_device():
    mesh = make_mesh(2, 4)
    B = 2
    cams = batched_cameras(B, seed=3)
    raw = scene_params(32, seed=4)
    opt = mtrain.make_optimizer(1e-2)
    state = mtrain.init_train_state(raw, opt)
    targets = jnp.zeros((B, 64, 64, 3))

    s_single, loss_single = jax.jit(lambda s, c, t: mtrain.train_step(
        s, c, t, opt, config=CFG
    ))(state, cams, targets)
    s_shard, loss_shard = jax.jit(lambda s, c, t: mtrain.train_step_sharded(
        s, c, t, opt, mesh, config=CFG
    ))(state, cams, targets)
    np.testing.assert_allclose(
        float(loss_shard), float(loss_single), rtol=1e-5
    )
    for k in s_single.params:
        np.testing.assert_allclose(
            np.asarray(s_shard.params[k]), np.asarray(s_single.params[k]),
            atol=1e-5, rtol=1e-4,
        )


def test_training_reduces_loss():
    # End-to-end trainability: fit a tiny scene toward a constant image.
    mesh = make_mesh(2, 4)
    B = 2
    cams = batched_cameras(B, seed=5)
    raw = scene_params(32, seed=6)
    opt = mtrain.make_optimizer(2e-2)
    state = mtrain.init_train_state(raw, opt)
    targets = jnp.full((B, 64, 64, 3), 0.5)

    import functools

    step = jax.jit(
        functools.partial(
            mtrain.train_step_sharded, optimizer=opt, mesh=mesh, config=CFG
        )
    )
    losses = []
    for _ in range(8):
        state, loss = step(state, cameras=cams, targets=targets)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses


def test_indivisible_height_raises():
    mesh = make_mesh(1, 8)
    cams = batched_cameras(1, H=64)  # 64 not divisible by 8*16
    raw = scene_params(16)
    with pytest.raises(ValueError):
        render_batch_sharded(mtrain.activate(raw), cams, mesh, config=CFG)


def test_sharded_train_step_with_mcmc_regularizer():
    from mojosplat_jax.densify import MCMCConfig, mcmc_regularization

    B = 2
    cams = batched_cameras(B, H=128)
    params = scene_params(n=64, seed=9)
    mesh = make_mesh(2, 4)
    optimizer = mtrain.make_optimizer(1e-2)
    state = mtrain.init_train_state(params, optimizer)
    targets = jnp.zeros((B, 128, 64, 3), jnp.float32)
    mcfg = MCMCConfig()

    step = jax.jit(
        functools.partial(
            mtrain.train_step_sharded,
            optimizer=optimizer,
            mesh=mesh,
            config=CFG,
            loss_extra=lambda p: mcmc_regularization(p, mcfg),
        )
    )
    new_state, loss = step(state, cameras=cams, targets=targets)
    base_state, base_loss = jax.jit(
        functools.partial(
            mtrain.train_step_sharded, optimizer=optimizer, mesh=mesh,
            config=CFG,
        )
    )(state, cameras=cams, targets=targets)
    assert np.isfinite(float(loss))
    # The regularizer raises the loss and changes the update.
    assert float(loss) > float(base_loss)
    assert not np.allclose(
        np.asarray(new_state.params["scales"]),
        np.asarray(base_state.params["scales"]),
    )


def test_render_batch_sharded_surfels():
    # The 2DGS family over the same ('data','tile') mesh: sharded slabs
    # must reassemble to the single-device surfel render.
    from mojosplat_jax.surfel import render_surfels

    B = 2
    cams = batched_cameras(B, H=128)
    rng = np.random.default_rng(12)
    n = 64
    params = dict(
        means3d=jnp.asarray(np.concatenate(
            [rng.normal(0, 0.3, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))],
            axis=1).astype(np.float32)),
        scales=jnp.asarray(rng.normal(-1.8, 0.2, (n, 2)).astype(np.float32)),
        quats=jnp.asarray(rng.normal(0, 1, (n, 4)).astype(np.float32)),
        opacities=jnp.asarray(rng.uniform(0.3, 0.9, n).astype(np.float32)),
        features=jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
    )
    mesh = make_mesh(2, 4)
    imgs = jax.jit(lambda p, c: render_batch_sharded(
        p, c, mesh, config=CFG, primitive="2dgs"
    ))(params, cams)
    ref_fn = jit_render(render_surfels)
    for i in range(B):
        ref = ref_fn(params, single_camera(cams, i))
        np.testing.assert_allclose(
            np.asarray(imgs[i]), np.asarray(ref), atol=2e-5
        )


def test_sharded_surfel_train_step_matches_single_device():
    # train_step_sharded_surfel with both 2DGS regularizers vs a hand-built
    # single-device step computing the identical global loss.
    import optax

    from mojosplat_jax.surfel import (
        normal_consistency_terms,
        render_surfels,
    )

    B = 2
    cams = batched_cameras(B, H=128)
    rng = np.random.default_rng(21)
    n = 48
    raw = dict(
        means3d=jnp.asarray(np.concatenate(
            [rng.normal(0, 0.3, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))],
            axis=1).astype(np.float32)),
        scales=jnp.asarray(rng.normal(-1.8, 0.2, (n, 2)).astype(np.float32)),
        quats=jnp.asarray(rng.normal(0, 1, (n, 4)).astype(np.float32)),
        opacities_raw=jnp.asarray(rng.normal(1.0, 0.5, n).astype(np.float32)),
        features=jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
    )
    targets = jnp.asarray(
        rng.uniform(0, 1, (B, 128, 64, 3)).astype(np.float32)
    )
    opt = optax.adam(1e-2)
    nw, dw = 0.05, 0.01

    mesh = make_mesh(2, 4)
    state = mtrain.init_train_state(raw, opt)
    new_state, loss = jax.jit(
        lambda s, c, t: mtrain.train_step_sharded_surfel(
            s, c, t, opt, mesh, config=CFG,
            normal_weight=nw, distortion_weight=dw,
        ))(state, cams, targets)

    # Single-device reference: same loss on full images.
    def loss_fn(params):
        p = mtrain.activate(params)

        def one(i):
            cam = single_camera(cams, i)
            img, depth, normal, dist, aux = render_surfels(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, config=CFG, return_aux=True,
                return_depth=True, return_normals=True,
                return_distortion=True,
            )
            num, den = normal_consistency_terms(
                depth, normal, aux.raster.final_transmittance, cam
            )
            return (jnp.sum((img - targets[i]) ** 2), jnp.sum(dist),
                    num, den)

        terms = [one(i) for i in range(B)]
        photo = sum(t[0] for t in terms)
        dist = sum(t[1] for t in terms)
        num = sum(t[2] for t in terms)
        den = sum(t[3] for t in terms)
        return (photo / targets.size + dw * dist / (targets.size // 3)
                + nw * num / jnp.maximum(den, 1.0))

    ref_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(raw)
    updates, _ = opt.update(grads, opt.init(raw), raw)
    ref_params = optax.apply_updates(raw, updates)

    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    # Post-Adam params: near-zero gradients make Adam's m/(sqrt(v)+eps)
    # amplify fp summation-order differences up to ~lr, so tolerance is in
    # lr units (lr = 1e-2), not gradient units.
    for k in ref_params:
        np.testing.assert_allclose(
            np.asarray(new_state.params[k]), np.asarray(ref_params[k]),
            rtol=1e-3, atol=1e-3, err_msg=k,
        )


def test_zero1_matches_replicated_update():
    # ZeRO-1 optimizer-state sharding: slice-update + all_gather must equal
    # the replicated Adam update exactly (Adam is row-wise).
    import optax

    mesh = make_mesh(2, 4)
    n = 64  # divisible by 8 devices
    raw = mtrain.init_gaussians(jax.random.PRNGKey(4), n)
    opt = optax.adam(1e-2)
    cams = batched_cameras(2, H=64)
    rng = np.random.default_rng(30)
    targets = jnp.asarray(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))

    out = {}
    for z in (False, True):
        state = mtrain.init_train_state(raw, opt)
        step = jax.jit(lambda s, c, t, z=z: mtrain.train_step_sharded(
            s, c, t, opt, mesh, config=CFG, zero1=z
        ))
        for _ in range(2):  # two steps so sharded moments feed back in
            state, loss = step(state, cams, targets)
        out[z] = (state, float(loss))

    assert abs(out[True][1] - out[False][1]) < 1e-7
    for k in raw:
        np.testing.assert_allclose(
            np.asarray(out[True][0].params[k]),
            np.asarray(out[False][0].params[k]),
            atol=1e-7, err_msg=k,
        )
    # The zero1 moments are physically sharded over all 8 devices.
    mu = out[True][0].opt_state[0].mu["means3d"]
    assert len(mu.sharding.device_set) == 8


def test_zero1_surfel_step_smoke():
    import optax

    mesh = make_mesh(2, 4)
    cams = batched_cameras(2, H=128)
    rng = np.random.default_rng(31)
    n = 64
    raw = dict(
        means3d=jnp.asarray(np.concatenate(
            [rng.normal(0, 0.3, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))],
            axis=1).astype(np.float32)),
        scales=jnp.asarray(rng.normal(-1.8, 0.2, (n, 2)).astype(np.float32)),
        quats=jnp.asarray(rng.normal(0, 1, (n, 4)).astype(np.float32)),
        opacities_raw=jnp.asarray(
            rng.normal(1.0, 0.5, n).astype(np.float32)),
        features=jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
    )
    targets = jnp.asarray(
        rng.uniform(0, 1, (2, 128, 64, 3)).astype(np.float32))
    opt = optax.adam(1e-2)

    out = {}
    for z in (False, True):
        state = mtrain.init_train_state(raw, opt)
        state, loss = jax.jit(
            lambda s, c, t, z=z: mtrain.train_step_sharded_surfel(
                s, c, t, opt, mesh, config=CFG,
                normal_weight=0.05, distortion_weight=0.01, zero1=z,
            ))(state, cams, targets)
        out[z] = (state, float(loss))
    assert abs(out[True][1] - out[False][1]) < 1e-7
    for k in raw:
        np.testing.assert_allclose(
            np.asarray(out[True][0].params[k]),
            np.asarray(out[False][0].params[k]), atol=1e-7, err_msg=k,
        )


def test_init_multihost_single_host_noop(monkeypatch):
    from mojosplat_jax.parallel import init_multihost, is_primary
    from mojosplat_jax.parallel import multihost

    monkeypatch.delenv(multihost.ENV_COORD, raising=False)
    monkeypatch.delenv(multihost.ENV_NPROC, raising=False)
    monkeypatch.delenv(multihost.ENV_PID, raising=False)
    assert init_multihost() is False  # nothing configured -> no-op
    assert is_primary()  # single process is the primary
    assert len(jax.devices()) == 8  # backend untouched


def test_init_multihost_partial_env_rejected(monkeypatch):
    from mojosplat_jax.parallel import init_multihost
    from mojosplat_jax.parallel import multihost

    monkeypatch.setenv(multihost.ENV_COORD, "localhost:1234")
    monkeypatch.delenv(multihost.ENV_NPROC, raising=False)
    monkeypatch.delenv(multihost.ENV_PID, raising=False)
    with pytest.raises(ValueError):
        init_multihost()
