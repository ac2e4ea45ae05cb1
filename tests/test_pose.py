"""Camera-pose refinement tests: the se(3) delta module (apply_pose_delta)
and an end-to-end pose-recovery optimization."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from mojosplat_jax import (
    Camera,
    RenderConfig,
    apply_pose_delta,
    render_gaussians,
)
from mojosplat_jax import train as mtrain
from mojosplat_jax.camera import _rodrigues

CFG = RenderConfig(tile_capacity=64, chunk_size=32)


def make_camera(H=48, W=48):
    return Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=H, W=W,
        fx=40.0, fy=40.0, cx=W / 2.0, cy=H / 2.0,
    )


def rodrigues_np(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def test_rodrigues_matches_numpy():
    rng = np.random.default_rng(0)
    for _ in range(5):
        w = rng.normal(0, 0.7, 3).astype(np.float32)
        np.testing.assert_allclose(
            np.asarray(_rodrigues(jnp.asarray(w))), rodrigues_np(w),
            atol=1e-6,
        )
    # Tiny-angle Taylor branch ~ first-order exact.
    w = np.array([1e-5, -2e-5, 5e-6], np.float32)
    np.testing.assert_allclose(
        np.asarray(_rodrigues(jnp.asarray(w))), rodrigues_np(w), atol=1e-9
    )


def test_zero_delta_is_identity():
    cam = make_camera()
    out = apply_pose_delta(cam, jnp.zeros(6))
    np.testing.assert_array_equal(np.asarray(out.R), np.asarray(cam.R))
    np.testing.assert_array_equal(np.asarray(out.T), np.asarray(cam.T))
    # Gradient through the zero point is finite (Taylor switch).
    g = jax.grad(
        lambda d: jnp.sum(apply_pose_delta(cam, d).R)
        + jnp.sum(apply_pose_delta(cam, d).T)
    )(jnp.zeros(6))
    assert np.all(np.isfinite(np.asarray(g)))


def test_delta_composes_rotation_and_translation():
    cam = make_camera()
    w = jnp.array([0.0, 0.3, 0.0])
    t = jnp.array([0.1, -0.2, 0.05])
    out = apply_pose_delta(cam, jnp.concatenate([w, t]))
    dR = rodrigues_np(np.asarray(w))
    np.testing.assert_allclose(
        np.asarray(out.R), dR @ np.asarray(cam.R), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(out.T), dR @ np.asarray(cam.T) + np.asarray(t),
        atol=1e-6,
    )


def test_pose_recovery_by_gradient_descent():
    # Fix the scene; render the target with the true camera; start from a
    # perturbed camera and optimize ONLY the se(3) delta. The delta must
    # undo most of the perturbation.
    p = mtrain.activate(
        mtrain.init_gaussians(jax.random.PRNGKey(3), 40, position_scale=0.8)
    )
    cam = make_camera()
    target = render_gaussians(
        p["means3d"], p["scales"], p["quats"], p["opacities"],
        p["features"], cam, config=CFG,
    )

    true_pert = jnp.array([0.01, -0.015, 0.008, 0.02, -0.01, 0.015])
    cam_bad = apply_pose_delta(cam, true_pert)

    def loss_fn(d):
        img = render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], apply_pose_delta(cam_bad, d), config=CFG,
        )
        return jnp.mean((img - target) ** 2)

    opt = optax.adam(3e-3)

    @jax.jit
    def step(d, s):
        loss, g = jax.value_and_grad(loss_fn)(d)
        upd, s = opt.update(g, s, d)
        return optax.apply_updates(d, upd), s, loss

    d = jnp.zeros(6)
    s = opt.init(d)
    loss0 = float(loss_fn(d))
    for _ in range(80):
        d, s, loss = step(d, s)
    assert float(loss) < 0.25 * loss0, (loss0, float(loss))
    # The recovered camera is closer to the truth than the perturbed one:
    # compare rotations via the relative angle and translations directly.
    cam_rec = apply_pose_delta(cam_bad, d)
    def rot_err(c):
        Rrel = np.asarray(c.R) @ np.asarray(cam.R).T
        return np.degrees(np.arccos(np.clip((np.trace(Rrel) - 1) / 2, -1, 1)))
    assert rot_err(cam_rec) < 0.7 * rot_err(cam_bad)
    t_err_bad = np.linalg.norm(np.asarray(cam_bad.T) - np.asarray(cam.T))
    t_err_rec = np.linalg.norm(np.asarray(cam_rec.T) - np.asarray(cam.T))
    assert t_err_rec < 0.7 * t_err_bad


def test_pose_and_param_grads_finite_with_dead_padded_slots():
    # Regression: camera/pose gradients SUM over every gaussian, so inf/NaN
    # born in culled lanes' backward poisons them even though the forward
    # image is fine. Dead zero-padded slots sit exactly at the origin
    # (z = 0, zero SH view direction) — both the EWA 1/z^2 overflow and the
    # normalize(0) SH direction had to be input-sanitized.
    from mojosplat_jax.densify import pad_to_capacity

    raw = mtrain.init_gaussians(
        jax.random.PRNGKey(1), 20, sh_degree=1, position_scale=0.5
    )
    raw["means3d"] = raw["means3d"] + jnp.array([0.0, 0.0, 2.0])
    raw = pad_to_capacity(raw, 32)
    cam = make_camera()
    target = jnp.zeros((48, 48, 3))

    def loss_fn(params, d):
        p = mtrain.activate(params)
        img = render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], apply_pose_delta(cam, d), sh_degree=1,
            config=CFG,
        )
        return mtrain.dssim_l1_loss(img, target)

    loss, (g, pg) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        raw, jnp.zeros(6)
    )
    assert np.isfinite(float(loss))
    assert np.all(np.isfinite(np.asarray(pg))) and np.abs(pg).max() > 0
    for k, v in g.items():
        assert np.all(np.isfinite(np.asarray(v))), k
