"""Projection stage tests.

Mirrors the reference's projection test strategy
(/root/reference/tests/test_projection_mojo.py): cross-implementation parity
against an independent oracle plus property/geometry sanity checks. The oracle
here is a from-scratch numpy EWA implementation inside this file (the reference
uses gsplat CUDA as its oracle; ours must run on CPU). Tolerances follow the
reference parity tests: means2d 1e-3, depths 1e-4, conics 1e-2, radii +-1px
(test_projection_mojo.py:119-180).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mojosplat_jax import Camera, RenderConfig
from mojosplat_jax.ops.projection import (
    project_gaussians,
    quat_scale_to_covar,
    quat_to_rotmat,
)

ALPHA_THRESHOLD = 1.0 / 255.0


def make_camera(H=64, W=64, fx=100.0, fy=100.0, R=None, T=None, near=0.1, far=100.0):
    """Identity camera at origin (test_projection_mojo.py make_camera analogue)."""
    if R is None:
        R = np.eye(3, dtype=np.float32)
    if T is None:
        T = np.zeros(3, dtype=np.float32)
    return Camera.create(R=R, T=T, H=H, W=W, fx=fx, fy=fy, cx=W / 2, cy=H / 2,
                         near=near, far=far)


def make_gaussians(n, seed=0, depth_range=(1.5, 5.0), spread=0.5):
    rng = np.random.default_rng(seed)
    means = np.concatenate(
        [
            rng.normal(0, spread, (n, 2)),
            rng.uniform(*depth_range, (n, 1)),
        ],
        axis=1,
    ).astype(np.float32)
    log_scales = rng.normal(-1.5, 0.2, (n, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.5, 0.95, n).astype(np.float32)
    return means, log_scales, quats, opac


# --------------------------------------------------------------------------
# Independent numpy oracle (EWA projection, gsplat numerical contract).
# --------------------------------------------------------------------------

def numpy_project(means, log_scales, quats, opac, cam, eps2d=0.3,
                  opacity_aware=True):
    N = means.shape[0]
    W, H = cam.W, cam.H
    fx, fy, cx, cy = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
    R_v = np.asarray(cam.R)
    T_v = np.asarray(cam.T)
    near, far = float(cam.near), float(cam.far)

    out = {
        "means2d": np.zeros((N, 2), np.float64),
        "conics": np.zeros((N, 3), np.float64),
        "depths": np.zeros(N, np.float64),
        "radii": np.zeros((N, 2), np.int64),
    }
    for i in range(N):
        q = quats[i] / np.linalg.norm(quats[i])
        w, x, y, z = q
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        S = np.diag(np.exp(log_scales[i]).astype(np.float64))
        M = R @ S
        cov = M @ M.T
        mc = R_v @ means[i] + T_v
        covc = R_v @ cov @ R_v.T
        tx, ty, tz = mc
        out["depths"][i] = tz
        if tz <= 0:
            tz_s = 1e-8
        else:
            tz_s = tz
        tan_fx, tan_fy = 0.5 * W / fx, 0.5 * H / fy
        lxp, lxn = (W - cx) / fx + 0.3 * tan_fx, cx / fx + 0.3 * tan_fx
        lyp, lyn = (H - cy) / fy + 0.3 * tan_fy, cy / fy + 0.3 * tan_fy
        txc = tz_s * np.clip(tx / tz_s, -lxn, lxp)
        tyc = tz_s * np.clip(ty / tz_s, -lyn, lyp)
        J = np.array(
            [
                [fx / tz_s, 0, -fx * txc / tz_s**2],
                [0, fy / tz_s, -fy * tyc / tz_s**2],
            ]
        )
        cov2d = J @ covc @ J.T
        c00, c11 = cov2d[0, 0] + eps2d, cov2d[1, 1] + eps2d
        c01 = cov2d[0, 1]
        det = max(c00 * c11 - c01 * c01, 1e-10)
        mean2d = np.array([fx * tx / tz_s + cx, fy * ty / tz_s + cy])
        out["means2d"][i] = mean2d
        out["conics"][i] = [c11 / det, -c01 / det, c00 / det]
        if opacity_aware:
            if opac[i] < ALPHA_THRESHOLD:
                continue
            extend = min(3.33, math.sqrt(2 * math.log(opac[i] / ALPHA_THRESHOLD)))
        else:
            extend = 3.33
        rx = math.ceil(extend * math.sqrt(max(c00, 0)))
        ry = math.ceil(extend * math.sqrt(max(c11, 0)))
        if not (det > 0 and near < tz < far):
            continue
        if rx <= 0 and ry <= 0:
            continue
        if (
            mean2d[0] + rx <= 0
            or mean2d[0] - rx >= W
            or mean2d[1] + ry <= 0
            or mean2d[1] - ry >= H
        ):
            continue
        out["radii"][i] = [rx, ry]
    return out


# --------------------------------------------------------------------------
# Parity vs the numpy oracle (reference: TestMojoVsGsplat, :83-197).
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 10, 100, 500])
@pytest.mark.parametrize("offset_cam", [False, True])
def test_parity_vs_numpy_oracle(n, offset_cam):
    means, log_scales, quats, opac = make_gaussians(n, seed=n)
    if offset_cam:
        theta = 0.2
        R = np.array(
            [
                [math.cos(theta), 0, math.sin(theta)],
                [0, 1, 0],
                [-math.sin(theta), 0, math.cos(theta)],
            ],
            dtype=np.float32,
        )
        cam = make_camera(R=R, T=np.array([0.1, -0.05, 0.2], np.float32))
    else:
        cam = make_camera()

    res = project_gaussians(
        jnp.asarray(means), jnp.asarray(log_scales), jnp.asarray(quats),
        jnp.asarray(opac), cam,
    )
    ref = numpy_project(means, log_scales, quats, opac, cam)

    # Compare only gaussians visible in both (test_projection_mojo.py:112-114).
    vis = (np.asarray(res.radii[:, 0]) > 0) & (ref["radii"][:, 0] > 0)
    assert vis.sum() > 0, "no visible gaussians to compare"
    np.testing.assert_allclose(
        np.asarray(res.means2d)[vis], ref["means2d"][vis], rtol=1e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res.depths)[vis], ref["depths"][vis], rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(res.conics)[vis], ref["conics"][vis], rtol=1e-2, atol=1e-2
    )
    assert np.all(np.abs(np.asarray(res.radii)[vis] - ref["radii"][vis]) <= 1)
    # Culling agreement (reference allows <=5% mismatch, :182-197).
    ours_culled = np.asarray(res.radii[:, 0]) == 0
    ref_culled = ref["radii"][:, 0] == 0
    assert (ours_culled != ref_culled).mean() <= 0.05


# --------------------------------------------------------------------------
# Property / geometry checks (test_projection_mojo.py:203-317 analogues).
# --------------------------------------------------------------------------

def test_quat_identity_rotmat():
    R = quat_to_rotmat(jnp.array([1.0, 0.0, 0.0, 0.0]))
    np.testing.assert_allclose(np.asarray(R), np.eye(3), atol=1e-6)


def test_quat_z_90deg():
    # 90deg about z: w=cos(45), z=sin(45); maps x->y.
    s = math.sqrt(0.5)
    R = np.asarray(quat_to_rotmat(jnp.array([s, 0.0, 0.0, s])))
    np.testing.assert_allclose(R @ np.array([1.0, 0, 0]), [0, 1, 0], atol=1e-6)


def test_covar_is_rsrt():
    q = jnp.array([[0.9, 0.1, -0.2, 0.3]])
    s = jnp.array([[0.5, 1.0, 2.0]])
    cov = np.asarray(quat_scale_to_covar(q, s))[0]
    np.testing.assert_allclose(cov, cov.T, atol=1e-6)
    assert np.all(np.linalg.eigvalsh(cov) > 0)
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(cov)),
                               np.sort(np.asarray(s[0]) ** 2), rtol=1e-5)


def test_on_axis_projects_to_center():
    cam = make_camera()
    res = project_gaussians(
        jnp.array([[0.0, 0.0, 3.0]]),
        jnp.full((1, 3), -2.0),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.9]),
        cam,
    )
    np.testing.assert_allclose(
        np.asarray(res.means2d[0]), [cam.W / 2, cam.H / 2], atol=2.0
    )
    assert res.radii[0, 0] > 0


def test_depth_equals_z_identity_camera():
    zs = np.array([1.2, 2.5, 7.0], np.float32)
    means = np.stack([np.zeros(3), np.zeros(3), zs], axis=1).astype(np.float32)
    res = project_gaussians(
        jnp.asarray(means),
        jnp.full((3, 3), -2.0),
        jnp.tile(jnp.array([[1.0, 0, 0, 0]]), (3, 1)),
        jnp.full((3,), 0.9),
        make_camera(),
    )
    np.testing.assert_allclose(np.asarray(res.depths), zs, rtol=1e-5)


def test_low_opacity_culled():
    res = project_gaussians(
        jnp.array([[0.0, 0.0, 3.0]]),
        jnp.full((1, 3), -2.0),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.5 / 255.0]),
        make_camera(),
    )
    assert int(res.radii[0, 0]) == 0 and int(res.radii[0, 1]) == 0


def test_behind_camera_culled():
    res = project_gaussians(
        jnp.array([[0.0, 0.0, -3.0]]),
        jnp.full((1, 3), -2.0),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.9]),
        make_camera(),
    )
    assert int(res.radii[0, 0]) == 0


def test_far_plane_culled():
    # The reference torch backend culls depth >= far (projection.py:271); the
    # mojo kernel forgot this check (SURVEY.md hard-parts) — we follow torch.
    res = project_gaussians(
        jnp.array([[0.0, 0.0, 150.0]]),
        jnp.full((1, 3), 1.0),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.9]),
        make_camera(far=100.0),
    )
    assert int(res.radii[0, 0]) == 0


def test_outside_viewport_culled():
    res = project_gaussians(
        jnp.array([[50.0, 0.0, 2.0]]),  # projects far off the 64px image
        jnp.full((1, 3), -2.0),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.9]),
        make_camera(),
    )
    assert int(res.radii[0, 0]) == 0


def test_isotropic_cov2d_value():
    # Isotropic gaussian, scale s, depth z, focal f: cov2d diag = (f s / z)^2
    # + eps2d; conic diag = 1 / that.
    s, z, f = 0.2, 4.0, 100.0
    cam = make_camera(fx=f, fy=f)
    res = project_gaussians(
        jnp.array([[0.0, 0.0, z]]),
        jnp.full((1, 3), math.log(s)),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.9]),
        cam,
    )
    expected = (f * s / z) ** 2 + 0.3
    np.testing.assert_allclose(np.asarray(res.conics[0, 0]), 1 / expected, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(res.conics[0, 2]), 1 / expected, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(res.conics[0, 1]), 0.0, atol=1e-6)


def test_anisotropic_45deg_conic_cross_term():
    # A 45deg-rotated anisotropic gaussian must produce a nonzero conic cross
    # term (reference TestNonTrivialRotations, :261-317).
    angle = math.pi / 4
    quat = jnp.array([[math.cos(angle / 2), 0.0, 0.0, math.sin(angle / 2)]])
    res = project_gaussians(
        jnp.array([[0.0, 0.0, 3.0]]),
        jnp.array([[math.log(0.5), math.log(0.05), math.log(0.05)]]),
        quat,
        jnp.array([0.9]),
        make_camera(),
    )
    assert abs(float(res.conics[0, 1])) > 1e-3


def test_torch_style_fixed_radius():
    # opacity_aware_radius=False reproduces the torch backend's plain 3.33
    # radius (projection.py:266-267) — larger than the opacity-aware one.
    args = (
        jnp.array([[0.0, 0.0, 3.0]]),
        jnp.full((1, 3), -1.0),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.6]),
    )
    cam = make_camera(H=256, W=256)
    r_aware = project_gaussians(*args, cam, RenderConfig(opacity_aware_radius=True))
    r_fixed = project_gaussians(*args, cam, RenderConfig(opacity_aware_radius=False))
    assert int(r_fixed.radii[0, 0]) >= int(r_aware.radii[0, 0])
    ext = math.sqrt(2 * math.log(0.6 / ALPHA_THRESHOLD))
    assert ext < 3.33  # opacity-aware is genuinely active for this opacity


def test_gradients_flow_and_finite():
    means, log_scales, quats, opac = make_gaussians(32, seed=3)
    cam = make_camera()

    def loss(m, s, q, o):
        res = project_gaussians(jnp.asarray(m), s, q, o, cam)
        return jnp.sum(res.means2d**2) + jnp.sum(res.conics**2)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(means), jnp.asarray(log_scales), jnp.asarray(quats),
        jnp.asarray(opac),
    )
    for g in grads[:3]:
        assert np.all(np.isfinite(np.asarray(g)))
    assert np.abs(np.asarray(grads[0])).max() > 0


def test_jit_no_recompile_across_scenes():
    # Changing the scene content (same shapes) must reuse the compiled program
    # (the no-recompile requirement, SURVEY.md section 5 metrics row).
    cam = make_camera()
    fn = jax.jit(lambda m, s, q, o: project_gaussians(m, s, q, o, cam))
    means, log_scales, quats, opac = make_gaussians(16, seed=1)
    fn(jnp.asarray(means), jnp.asarray(log_scales), jnp.asarray(quats),
       jnp.asarray(opac))
    n0 = fn._cache_size()
    means2, log_scales2, quats2, opac2 = make_gaussians(16, seed=2)
    fn(jnp.asarray(means2), jnp.asarray(log_scales2), jnp.asarray(quats2),
       jnp.asarray(opac2))
    assert fn._cache_size() == n0


def test_antialiased_compensation_value():
    # Isotropic gaussian: cov2d diag = (f s / z)^2, so the compensation is
    # sqrt(v^2 / (v + eps2d)^2) = v / (v + eps2d) (Mip-Splatting opacity
    # compensation; gsplat calc_compensations semantics).
    s, z, f = 0.2, 4.0, 100.0
    cam = make_camera(fx=f, fy=f)
    args = (
        jnp.array([[0.0, 0.0, z]]),
        jnp.full((1, 3), math.log(s)),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.9]),
        cam,
    )
    res = project_gaussians(*args, RenderConfig(antialiased=True))
    v = (f * s / z) ** 2
    np.testing.assert_allclose(
        float(res.compensations[0]), v / (v + 0.3), rtol=1e-5
    )
    # Classic mode fills 1.0 and is otherwise identical.
    classic = project_gaussians(*args, RenderConfig())
    np.testing.assert_allclose(np.asarray(classic.compensations), 1.0)
    np.testing.assert_allclose(
        np.asarray(classic.conics), np.asarray(res.conics)
    )


def test_antialiased_compensation_bounds_and_grads():
    means, log_scales, quats, opac = make_gaussians(64, seed=7)
    cam = make_camera()
    cfg = RenderConfig(antialiased=True)
    res = project_gaussians(
        jnp.asarray(means), jnp.asarray(log_scales), jnp.asarray(quats),
        jnp.asarray(opac), cam, cfg,
    )
    comp = np.asarray(res.compensations)
    assert np.all(comp >= 0.0) and np.all(comp <= 1.0)
    # Sub-pixel splats are compensated harder than big ones.
    big = project_gaussians(
        jnp.asarray(means), jnp.asarray(log_scales) + 2.0, jnp.asarray(quats),
        jnp.asarray(opac), cam, cfg,
    )
    assert float(jnp.mean(big.compensations)) > float(
        jnp.mean(res.compensations)
    )

    def f(ls):
        r = project_gaussians(
            jnp.asarray(means), ls, jnp.asarray(quats), jnp.asarray(opac),
            cam, cfg,
        )
        return jnp.sum(r.compensations)

    g = jax.grad(f)(jnp.asarray(log_scales))
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.max(jnp.abs(g))) > 0.0


def test_unscented_matches_ewa_in_linear_regime():
    # Small, distant gaussians: the pinhole map is locally linear, so the
    # UT moments must agree with the EWA linearization.
    means, log_scales, quats, opac = make_gaussians(
        128, seed=12, depth_range=(6.0, 12.0)
    )
    log_scales = log_scales - 2.0  # tiny splats
    cam = make_camera(far=200.0)
    args = (jnp.asarray(means), jnp.asarray(log_scales), jnp.asarray(quats),
            jnp.asarray(opac), cam)
    ewa = project_gaussians(*args, RenderConfig())
    ut = project_gaussians(*args, RenderConfig(projection_mode="ut"))
    vis = (np.asarray(ewa.radii[:, 0]) > 0) & (np.asarray(ut.radii[:, 0]) > 0)
    assert vis.sum() > 50
    np.testing.assert_allclose(
        np.asarray(ut.means2d)[vis], np.asarray(ewa.means2d)[vis],
        rtol=1e-3, atol=5e-3,
    )
    np.testing.assert_allclose(
        np.asarray(ut.depths)[vis], np.asarray(ewa.depths)[vis], rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(ut.conics)[vis], np.asarray(ewa.conics)[vis],
        rtol=2e-2, atol=1e-3,
    )


def test_unscented_diverges_for_near_large_splats():
    # A big near splat: EWA's first-order Jacobian underestimates the
    # perspective curvature; UT must produce a different (and valid,
    # positive-definite) covariance.
    cam = make_camera()
    args = (
        jnp.array([[0.3, 0.2, 0.9]]),
        jnp.full((1, 3), -0.5),
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.9]),
        cam,
    )
    ewa = project_gaussians(*args, RenderConfig())
    ut = project_gaussians(*args, RenderConfig(projection_mode="ut"))
    a, b, c = [float(x) for x in ut.conics[0]]
    assert a > 0 and c > 0 and a * c - b * b > 0  # PSD conic
    rel = abs(float(ut.conics[0, 0]) - float(ewa.conics[0, 0])) / float(
        ewa.conics[0, 0]
    )
    assert rel > 0.02


def test_unscented_gradients_flow():
    means, log_scales, quats, opac = make_gaussians(32, seed=13)
    cam = make_camera()
    cfg = RenderConfig(projection_mode="ut")

    def f(m, ls):
        r = project_gaussians(
            m, ls, jnp.asarray(quats), jnp.asarray(opac), cam, cfg
        )
        return jnp.sum(r.means2d**2) + jnp.sum(r.conics**2)

    gm, gs = jax.grad(f, argnums=(0, 1))(
        jnp.asarray(means), jnp.asarray(log_scales)
    )
    assert np.all(np.isfinite(np.asarray(gm)))
    assert np.all(np.isfinite(np.asarray(gs)))
    assert float(jnp.max(jnp.abs(gm))) > 0


def test_unscented_end_to_end_render():
    from mojosplat_jax import render_gaussians

    rng = np.random.default_rng(3)
    n = 100
    means = np.concatenate(
        [rng.normal(0, 0.3, (n, 2)), rng.uniform(1.5, 4.0, (n, 1))], axis=1
    ).astype(np.float32)
    cam = make_camera()
    common = dict(
        means3d=jnp.asarray(means),
        scales=jnp.asarray(rng.normal(-1.8, 0.2, (n, 3)).astype(np.float32)),
        quats=jnp.asarray(
            rng.normal(0, 1, (n, 4)).astype(np.float32)
        ),
        opacities=jnp.asarray(rng.uniform(0.4, 0.9, n).astype(np.float32)),
        features=jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
        camera=cam,
    )
    img_ut = render_gaussians(
        **common,
        config=RenderConfig(projection_mode="ut", tile_capacity=128,
                            chunk_size=32),
    )
    img_ewa = render_gaussians(
        **common, config=RenderConfig(tile_capacity=128, chunk_size=32)
    )
    assert np.all(np.isfinite(np.asarray(img_ut)))
    # Same scene, slightly different linearizations: images are close but
    # not identical.
    diff = float(jnp.mean(jnp.abs(img_ut - img_ewa)))
    assert diff < 0.05


def test_unscented_grads_finite_with_behind_camera_gaussians():
    # Regression: behind-camera sigma points must not leak NaN into the
    # full render gradient (double-where input sanitization).
    from mojosplat_jax import render_gaussians

    rng = np.random.default_rng(4)
    n = 200
    means = rng.normal(0, 0.8, (n, 3)).astype(np.float32)  # half behind
    cam = make_camera()
    cfg = RenderConfig(projection_mode="ut", tile_capacity=128, chunk_size=32)
    p = dict(
        means3d=jnp.asarray(means),
        scales=jnp.asarray(rng.normal(-1.8, 0.3, (n, 3)).astype(np.float32)),
        quats=jnp.asarray(rng.normal(0, 1, (n, 4)).astype(np.float32)),
        opacities=jnp.asarray(rng.uniform(0.3, 0.9, n).astype(np.float32)),
        features=jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
    )

    def loss(q):
        img = render_gaussians(
            q["means3d"], q["scales"], q["quats"], q["opacities"],
            q["features"], cam, config=cfg,
        )
        return jnp.mean(img**2)

    g = jax.grad(loss)(p)
    for k, v in g.items():
        assert np.all(np.isfinite(np.asarray(v))), f"NaN grad in {k}"
    assert float(jnp.linalg.norm(g["means3d"])) > 0


def test_distortion_zero_coeffs_identical():
    means, log_scales, quats, opac = make_gaussians(32, seed=15)
    cam0 = make_camera()
    camz = Camera.create(
        R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32), H=64, W=64,
        fx=100.0, fy=100.0, cx=32.0, cy=32.0, dist=np.zeros(5, np.float32),
    )
    cfg = RenderConfig(projection_mode="ut")
    a = project_gaussians(jnp.asarray(means), jnp.asarray(log_scales),
                          jnp.asarray(quats), jnp.asarray(opac), cam0, cfg)
    b = project_gaussians(jnp.asarray(means), jnp.asarray(log_scales),
                          jnp.asarray(quats), jnp.asarray(opac), camz, cfg)
    np.testing.assert_array_equal(np.asarray(a.means2d), np.asarray(b.means2d))
    np.testing.assert_array_equal(np.asarray(a.conics), np.asarray(b.conics))


def test_radial_distortion_moves_points_outward():
    # Positive k1 (barrel in this forward convention) pushes off-center
    # points AWAY from the principal point by (1 + k1 r^2).
    cam = Camera.create(
        R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
        H=64, W=64, fx=100.0, fy=100.0, cx=32.0, cy=32.0,
        dist=np.array([0.2, 0.0, 0.0, 0.0, 0.0], np.float32),
    )
    cfg = RenderConfig(projection_mode="ut")
    res = project_gaussians(
        jnp.array([[0.4, 0.0, 2.0]]),  # xn = 0.2
        jnp.full((1, 3), -4.0),  # near-point splat: mean is the projection
        jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        jnp.array([0.9]),
        cam, cfg,
    )
    xn = 0.2
    expected = 100.0 * xn * (1.0 + 0.2 * xn * xn) + 32.0
    # atol 0.01 px: the UT mean legitimately differs from the pushed center
    # by the curvature-induced shift of the finite sigma points.
    np.testing.assert_allclose(float(res.means2d[0, 0]), expected, atol=1e-2)
    np.testing.assert_allclose(float(res.means2d[0, 1]), 32.0, atol=1e-2)


def test_colmap_distortion_mapping():
    from mojosplat_jax.utils.colmap import ColmapCamera, camera_intrinsics

    cam = ColmapCamera(1, 2, 640, 480,
                       np.array([500.0, 320.0, 240.0, 0.05]))
    fx, fy, cx, cy, W, H, dist, model = camera_intrinsics(cam)
    assert fx == fy == 500.0 and dist[0] == np.float32(0.05)
    assert np.all(dist[1:] == 0) and model == "pinhole"
    cam4 = ColmapCamera(1, 4, 640, 480,
                        np.array([500.0, 505.0, 320.0, 240.0,
                                  0.1, -0.02, 1e-3, -2e-3]))
    *_, dist4, model4 = camera_intrinsics(cam4, downscale=2)
    np.testing.assert_allclose(dist4[:4], [0.1, -0.02, 1e-3, -2e-3],
                               rtol=1e-6)
    assert model4 == "pinhole"


def test_antialiased_grads_finite_with_degenerate_splats():
    # Regression (code review): sqrt(det_raw/det) backward was inf at
    # det_raw == 0 (behind-camera UT lanes map to an exactly-zero raw
    # covariance), leaking NaN into intrinsics/pose gradients.
    means = jnp.array([[0.1, 0.0, 2.0], [0.0, 0.0, -1.0]])  # one behind
    log_scales = jnp.full((2, 3), -1.5)
    quats = jnp.array([[1.0, 0.0, 0.0, 0.0]] * 2)
    opac = jnp.array([0.9, 0.9])
    cfg = RenderConfig(projection_mode="ut", antialiased=True)

    def f(fx):
        cam = Camera.create(
            R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
            H=64, W=64, fx=fx, fy=100.0, cx=32.0, cy=32.0,
        )
        r = project_gaussians(means, log_scales, quats, opac, cam, cfg)
        return jnp.sum(r.compensations * opac) + jnp.sum(r.means2d)

    g = jax.grad(f)(jnp.asarray(100.0))
    assert np.isfinite(float(g))
    # Same guard in EWA mode.
    cfg_ewa = RenderConfig(antialiased=True)

    def f2(fx):
        cam = Camera.create(
            R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
            H=64, W=64, fx=fx, fy=100.0, cx=32.0, cy=32.0,
        )
        r = project_gaussians(means, log_scales, quats, opac, cam, cfg_ewa)
        return jnp.sum(r.compensations * opac)

    assert np.isfinite(float(jax.grad(f2)(jnp.asarray(100.0))))
