"""Rolling-shutter camera model (Camera.shutter="rolling", UT-routed).

Reference: the 3DGUT rolling-shutter formulation — mid-exposure pose plus an
se(3) frame velocity, per-point row time solved by fixed-point iteration
through the exact camera map. The reference renderer has no camera motion
model at all (its Camera is a static pose, /root/reference/mojosplat/
utils.py:5-31); this is a capability extension validated against an
independent numpy transcription.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax.ops.projection import project_gaussians

H, W = 240, 320
FX = FY = 200.0


def make_camera(rs_vel=None, shutter="global"):
    return Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=H, W=W, fx=FX, fy=FY,
        cx=W / 2, cy=H / 2, rs_vel=rs_vel, shutter=shutter,
    )


def make_scene(n=64, seed=0):
    rng = np.random.default_rng(seed)
    means = np.stack(
        [
            rng.uniform(-1.0, 1.0, n),
            rng.uniform(-0.6, 0.6, n),
            rng.uniform(2.0, 6.0, n),
        ],
        axis=-1,
    ).astype(np.float32)
    scales = np.full((n, 3), -4.0, np.float32)  # tiny, point-like
    quats = np.tile(np.array([1.0, 0.0, 0.0, 0.0], np.float32), (n, 1))
    opac = np.full((n,), 0.9, np.float32)
    return jnp.array(means), jnp.array(scales), jnp.array(quats), jnp.array(opac)


def numpy_rs_project(p, om, up, iters=2):
    """Independent fixed-point rolling-shutter projection of one point."""
    t = 0.0
    for _ in range(iters + 1):
        th = np.linalg.norm(om * t)
        if th < 1e-12:
            Rt = np.eye(3)
        else:
            k = om * t / th
            Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
            Rt = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        q = Rt @ p + t * up
        u = FX * q[0] / q[2] + W / 2
        v = FY * q[1] / q[2] + H / 2
        t = np.clip(v / H, 0.0, 1.0) - 0.5
    return u, v


def project(cam, means, scales, quats, opac, **cfg_kw):
    cfg = RenderConfig(projection_mode="ut", **cfg_kw)
    return jax.jit(
        lambda m, s, q, o, c: project_gaussians(m, s, q, o, c, cfg)
    )(means, scales, quats, opac, cam)


class TestRollingShutter:
    def test_zero_velocity_matches_global(self):
        means, scales, quats, opac = make_scene()
        glob = project(make_camera(), means, scales, quats, opac)
        roll = project(
            make_camera(rs_vel=jnp.zeros(6), shutter="rolling"),
            means, scales, quats, opac,
        )
        np.testing.assert_allclose(
            glob.means2d, roll.means2d, atol=1e-4, rtol=1e-5
        )
        np.testing.assert_allclose(
            glob.conics, roll.conics, atol=1e-3, rtol=1e-3
        )
        np.testing.assert_allclose(glob.depths, roll.depths, atol=1e-5)

    @pytest.mark.parametrize(
        "om,up",
        [
            (np.zeros(3), np.array([0.3, 0.0, 0.0])),  # lateral translation
            (np.array([0.0, 0.12, 0.0]), np.zeros(3)),  # yaw sweep
            (np.array([0.05, 0.08, 0.02]), np.array([0.1, -0.05, 0.2])),
        ],
    )
    def test_centers_match_numpy_fixed_point(self, om, up):
        means, scales, quats, opac = make_scene()
        vel = jnp.array(np.concatenate([om, up]), jnp.float32)
        proj = project(
            make_camera(rs_vel=vel, shutter="rolling"),
            means, scales, quats, opac,
        )
        m2d = np.asarray(proj.means2d)
        radii = np.asarray(proj.radii)
        checked = 0
        for i in range(means.shape[0]):
            u, v = numpy_rs_project(np.asarray(means[i]), om, up)
            if not (0 <= u < W and 0 <= v < H):
                continue  # culled / off-screen rows have clamped times
            if radii[i, 0] == 0:
                continue
            np.testing.assert_allclose(
                m2d[i], [u, v], atol=0.02,
                err_msg=f"gaussian {i}",
            )
            checked += 1
        assert checked >= 20  # the scene keeps most points on-screen

    def test_rows_displace_proportionally(self):
        # Pure lateral velocity: points landing on lower rows (later read)
        # must displace further in +x; top-row points barely move.
        means, scales, quats, opac = make_scene()
        vel = jnp.array([0, 0, 0, 0.4, 0.0, 0.0], jnp.float32)
        glob = project(make_camera(), means, scales, quats, opac)
        roll = project(
            make_camera(rs_vel=vel, shutter="rolling"),
            means, scales, quats, opac,
        )
        g = np.asarray(glob.means2d)
        r = np.asarray(roll.means2d)
        t = np.clip(g[:, 1] / H, 0.0, 1.0) - 0.5
        z = np.asarray(means[:, 2])
        expected_dx = t * 0.4 * FX / z
        mask = np.asarray(glob.radii[:, 0]) > 0
        np.testing.assert_allclose(
            (r[:, 0] - g[:, 0])[mask], expected_dx[mask], atol=0.05
        )

    def test_gradients_finite_at_zero_velocity(self):
        means, scales, quats, opac = make_scene(16)
        cam = make_camera(rs_vel=jnp.zeros(6), shutter="rolling")
        cfg = RenderConfig(projection_mode="ut")

        import dataclasses

        def loss(m, vel):
            c = dataclasses.replace(cam, rs_vel=vel)
            p = project_gaussians(m, scales, quats, opac, c, cfg)
            return jnp.sum(p.means2d**2) + jnp.sum(p.conics**2)

        g_m, g_v = jax.jit(jax.grad(loss, argnums=(0, 1)))(
            means, jnp.zeros(6)
        )
        assert np.all(np.isfinite(np.asarray(g_m)))
        assert np.all(np.isfinite(np.asarray(g_v)))
        # Lateral-velocity gradient must be live (rows below center shift).
        assert float(jnp.abs(g_v[3])) > 0

    def test_full_render_smoke(self):
        means, scales, quats, opac = make_scene(32)
        colors = jnp.tile(jnp.array([[0.8, 0.3, 0.2]]), (32, 1))
        cam = make_camera(
            rs_vel=jnp.array([0, 0.1, 0, 0.2, 0, 0]), shutter="rolling"
        )
        cfg = RenderConfig(tile_capacity=128, chunk_size=32, max_tile_span=4)
        img = jax.jit(
            lambda m, c: render_gaussians(
                m, scales, quats, opac, colors, c,
                background_color=jnp.zeros(3), config=cfg,
            )
        )(means, cam)
        assert img.shape == (H, W, 3)
        assert bool(jnp.all(jnp.isfinite(img)))
        assert float(img.max()) > 0.05
