"""Backward-pass tests — the capability the reference lacks entirely
(render_gaussians is @torch.no_grad(), /root/reference/mojosplat/render.py:11;
README.md:145 lists the backward as future work). Strategy per SURVEY.md
section 4: finite-difference gradient checks plus determinism on the CPU
(on a GPU the scatter-add that routes per-slot gradients to gaussians uses
atomics, whose order changes from run to run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax.ops.sh import num_sh_bases

CFG = RenderConfig(tile_capacity=128, chunk_size=32)


def make_camera(H=32, W=32, fx=50.0):
    return Camera.create(
        R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
        H=H, W=W, fx=fx, fy=fx, cx=W / 2, cy=H / 2,
    )


def make_scene(n=6, seed=0):
    rng = np.random.default_rng(seed)
    params = dict(
        means3d=jnp.asarray(
            np.concatenate(
                [rng.normal(0, 0.25, (n, 2)), rng.uniform(1.8, 3.5, (n, 1))],
                axis=1,
            ),
            jnp.float32,
        ),
        scales=jnp.asarray(rng.normal(-1.6, 0.1, (n, 3)), jnp.float32),
        quats=jnp.asarray(rng.normal(0, 1, (n, 4)), jnp.float32),
        opacities=jnp.asarray(rng.uniform(0.4, 0.8, n), jnp.float32),
        features=jnp.asarray(rng.uniform(0.2, 0.8, (n, 3)), jnp.float32),
    )
    return params


def render_loss(params, cam, target, sh_degree=None):
    img = render_gaussians(
        **params, camera=cam, sh_degree=sh_degree,
        background_color=jnp.array([0.1, 0.1, 0.1]), config=CFG,
    )
    return jnp.mean((img - target) ** 2)


def test_grads_finite_and_nonzero_all_params():
    cam = make_camera()
    params = make_scene()
    target = jnp.zeros((cam.H, cam.W, 3))
    grads = jax.grad(render_loss)(params, cam, target)
    for name, g in grads.items():
        g = np.asarray(g)
        assert np.all(np.isfinite(g)), f"non-finite grad for {name}"
        assert np.abs(g).max() > 0, f"zero grad for {name}"


def test_grads_match_finite_differences():
    # Central finite differences in f64 on a handful of coordinates of every
    # parameter tensor. The pipeline is piecewise smooth; the scene is chosen
    # away from culling/termination thresholds.
    jax.config.update("jax_enable_x64", True)
    try:
        cam = make_camera()
        params = {
            k: v.astype(jnp.float64) for k, v in make_scene(4, seed=3).items()
        }
        target = jnp.full((cam.H, cam.W, 3), 0.2, jnp.float64)
        loss = lambda p: render_loss(p, cam, target)
        grads = jax.grad(loss)(params)
        eps = 1e-5
        rng = np.random.default_rng(0)
        for name in params:
            flat = np.asarray(params[name]).ravel()
            gflat = np.asarray(grads[name]).ravel()
            idxs = rng.choice(flat.size, size=min(5, flat.size), replace=False)
            for i in idxs:
                bump = np.zeros_like(flat)
                bump[i] = eps
                bshape = bump.reshape(params[name].shape)
                p_plus = {**params, name: params[name] + bshape}
                p_minus = {**params, name: params[name] - bshape}
                fd = (float(loss(p_plus)) - float(loss(p_minus))) / (2 * eps)
                ad = float(gflat[i])
                np.testing.assert_allclose(
                    ad, fd, rtol=5e-3, atol=1e-7,
                    err_msg=f"{name}[{i}]: autodiff {ad} vs fd {fd}",
                )
    finally:
        jax.config.update("jax_enable_x64", False)


def test_grads_deterministic():
    # Gradient accumulation is a deterministic XLA scatter-add, bitwise
    # reproducible (SURVEY.md section 5 race-detection row).
    cam = make_camera()
    params = make_scene(12, seed=5)
    target = jnp.zeros((cam.H, cam.W, 3))
    g = jax.jit(jax.grad(render_loss), static_argnums=(3,))
    g1 = g(params, cam, target, None)
    g2 = g(params, cam, target, None)
    for k in g1:
        assert np.array_equal(np.asarray(g1[k]), np.asarray(g2[k])), k


def test_grads_through_sh():
    cam = make_camera()
    params = make_scene(4, seed=7)
    K = num_sh_bases(2)
    rng = np.random.default_rng(1)
    params["features"] = jnp.asarray(
        rng.normal(0, 0.2, (4, K, 3)), jnp.float32
    )
    target = jnp.zeros((cam.H, cam.W, 3))
    grads = jax.grad(render_loss)(params, cam, target, 2)
    g = np.asarray(grads["features"])
    assert np.all(np.isfinite(g))
    assert np.abs(g).max() > 0
    # View-direction gradient flows back into means3d through SH too.
    assert np.abs(np.asarray(grads["means3d"])).max() > 0


def test_value_and_grad_jits():
    cam = make_camera()
    params = make_scene()
    target = jnp.zeros((cam.H, cam.W, 3))
    vg = jax.jit(jax.value_and_grad(render_loss), static_argnums=(3,))
    loss, grads = vg(params, cam, target, None)
    assert np.isfinite(float(loss))
    # Second call with a different scene: cache hit (no recompile).
    n0 = vg._cache_size()
    vg(make_scene(6, seed=9), cam, target, None)
    assert vg._cache_size() == n0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_camera_pose_gradients(impl):
    # Camera is a pytree of traced arrays, so pose refinement gradients
    # (dL/dT, dL/dR, dL/dfocal) come for free — a capability the
    # forward-only reference cannot offer. Finite-difference check uses one
    # image-spanning gaussian so tile membership (stop-gradient'ed binning
    # structure, as in all 3DGS implementations) cannot flip across the
    # probe and the comparison isolates the smooth path.
    cfg = RenderConfig(
        tile_capacity=128, chunk_size=32, raster_impl=impl,
        pallas_interpret=(impl == "pallas"),
    )
    target = jnp.zeros((64, 64, 3))

    def loss(T):
        cam = Camera.create(
            R=np.eye(3, dtype=np.float32), T=T, H=64, W=64,
            fx=100.0, fy=100.0, cx=32.0, cy=32.0,
        )
        img = render_gaussians(
            jnp.array([[0.05, -0.03, 2.0]]),
            jnp.full((1, 3), 0.2),  # huge: covers the whole viewport
            jnp.array([[1.0, 0.0, 0.0, 0.0]]),
            jnp.array([0.8]),
            jnp.array([[0.9, 0.4, 0.2]]),
            cam,
            config=cfg,
        )
        return jnp.mean((img - target) ** 2)

    T0 = jnp.zeros(3)
    g = jax.grad(loss)(T0)
    assert np.all(np.isfinite(np.asarray(g)))
    eps = 1e-3
    for axis in range(3):
        e = jnp.zeros(3).at[axis].set(eps)
        fd = (float(loss(T0 + e)) - float(loss(T0 - e))) / (2 * eps)
        np.testing.assert_allclose(float(g[axis]), fd, rtol=0.05, atol=1e-6)


def test_camera_pose_gradients_impl_parity():
    # On a multi-gaussian scene the xla and pallas paths must agree on the
    # (smooth-path) pose gradient exactly, since they share the binning
    # stop-gradient policy.
    rng = np.random.default_rng(21)
    n = 150
    means = np.concatenate(
        [rng.normal(0, 0.4, (n, 2)), rng.uniform(1.5, 4.0, (n, 1))], axis=1
    ).astype(np.float32)
    scales = rng.normal(-1.8, 0.2, (n, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    opac = rng.uniform(0.4, 0.9, n).astype(np.float32)
    feats = rng.uniform(0, 1, (n, 3)).astype(np.float32)

    def grad_for(impl):
        cfg = RenderConfig(
            tile_capacity=128, chunk_size=32, raster_impl=impl,
            pallas_interpret=(impl == "pallas"),
        )

        def loss(T):
            cam = Camera.create(
                R=np.eye(3, dtype=np.float32), T=T, H=64, W=64,
                fx=100.0, fy=100.0, cx=32.0, cy=32.0,
            )
            img = render_gaussians(
                jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
                jnp.asarray(opac), jnp.asarray(feats), cam, config=cfg,
            )
            return jnp.mean(img**2)

        return jax.grad(loss)(jnp.zeros(3))

    gx = np.asarray(grad_for("xla"))
    gp = np.asarray(grad_for("pallas"))
    assert np.all(np.isfinite(gx)) and np.linalg.norm(gx) > 0
    np.testing.assert_allclose(gp, gx, rtol=1e-4, atol=1e-7)
