"""Non-pinhole camera-model tests: fisheye (equidistant) and orthographic.

The reference has no alternative camera models at all (its intrinsics vector
reserves distortion slots but always zeroes them, projection.py:444-447);
gsplat — the reference's oracle — exposes camera_model="fisheye" and
"ortho". Here the fisheye lens map is validated against an independent numpy
transcription of the OpenCV cv::fisheye projection, ortho against its
closed form, and the full render paths are smoke- and gradient-checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax.ops.projection import project_gaussians


def fisheye_project_np(pts_cam, fx, fy, cx, cy, k=(0.0, 0.0, 0.0, 0.0)):
    """Independent numpy oracle: OpenCV equidistant fisheye projection of
    camera-frame points."""
    x, y, z = pts_cam[:, 0], pts_cam[:, 1], pts_cam[:, 2]
    a, b = x / z, y / z
    r = np.sqrt(a * a + b * b)
    th = np.arctan(r)
    th_d = th * (
        1.0
        + k[0] * th**2
        + k[1] * th**4
        + k[2] * th**6
        + k[3] * th**8
    )
    scale = np.where(r > 1e-12, th_d / np.maximum(r, 1e-12), 1.0)
    return np.stack([fx * a * scale + cx, fy * b * scale + cy], axis=-1)


def tiny_gaussians(pts):
    """Near-point gaussians so the UT mean ~ the exact projected center."""
    n = pts.shape[0]
    return (
        jnp.asarray(pts, jnp.float32),
        jnp.full((n, 3), -7.0),  # log-scales: ~1e-3 extent
        jnp.tile(jnp.array([1.0, 0.0, 0.0, 0.0]), (n, 1)),
        jnp.full((n,), 0.9),
    )


def make_camera(dist=None, H=480, W=640):
    return Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=H, W=W,
        fx=300.0, fy=310.0, cx=W / 2.0, cy=H / 2.0,
        dist=dist, camera_model="fisheye",
    )


CAM_PTS = np.array(
    [
        [0.0, 0.0, 2.0],  # on-axis (exercises the removable singularity)
        [0.5, -0.3, 2.0],
        [-1.5, 0.8, 1.4],  # wide angle ~50 deg off-axis
        [1.4, 0.1, 1.0],  # ~55 deg off-axis, still on the 640-px sensor
    ]
)


@pytest.mark.parametrize(
    "k", [(0.0, 0.0, 0.0, 0.0), (0.08, -0.01, 0.002, -0.0005)]
)
def test_ut_means_match_numpy_fisheye_oracle(k):
    cam = make_camera(dist=jnp.array(list(k) + [0.0]))
    means, log_scales, quats, opac = tiny_gaussians(CAM_PTS)  # R=I, T=0
    res = project_gaussians(
        means, log_scales, quats, opac, cam,
        RenderConfig(projection_mode="ut"),
    )
    expected = fisheye_project_np(CAM_PTS, 300.0, 310.0, 320.0, 240.0, k)
    np.testing.assert_allclose(np.asarray(res.means2d), expected, atol=5e-3)
    assert np.all(np.asarray(res.radii) > 0)  # all in front & on-screen


def test_fisheye_routes_ewa_config_through_ut():
    # camera_model="fisheye" must take the unscented path even when the
    # config asks for EWA (the default): results identical to explicit ut.
    cam = make_camera(dist=jnp.array([0.05, 0.0, 0.0, 0.0, 0.0]))
    means, log_scales, quats, opac = tiny_gaussians(CAM_PTS)
    r_ewa_cfg = project_gaussians(
        means, log_scales, quats, opac, cam, RenderConfig()
    )
    r_ut_cfg = project_gaussians(
        means, log_scales, quats, opac, cam,
        RenderConfig(projection_mode="ut"),
    )
    np.testing.assert_array_equal(
        np.asarray(r_ewa_cfg.means2d), np.asarray(r_ut_cfg.means2d)
    )
    np.testing.assert_array_equal(
        np.asarray(r_ewa_cfg.conics), np.asarray(r_ut_cfg.conics)
    )


def test_zero_distortion_fisheye_matches_pinhole_near_axis():
    # Equidistant u = f*theta vs pinhole u = f*tan(theta): within ~2 deg of
    # the axis they agree to (f * th^3 / 3) ~ 0.004 px at f=300.
    pts = np.array([[0.02, -0.015, 1.0], [0.0, 0.03, 1.2]])
    cam_f = make_camera()
    cam_p = Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=480, W=640,
        fx=300.0, fy=310.0, cx=320.0, cy=240.0,
    )
    means, log_scales, quats, opac = tiny_gaussians(pts)
    cfg = RenderConfig(projection_mode="ut")
    rf = project_gaussians(means, log_scales, quats, opac, cam_f, cfg)
    rp = project_gaussians(means, log_scales, quats, opac, cam_p, cfg)
    np.testing.assert_allclose(
        np.asarray(rf.means2d), np.asarray(rp.means2d), atol=2e-2
    )


def test_fisheye_render_smoke_and_center():
    # A gaussian on the optical axis renders at the image center; the image
    # is finite everywhere under the fisheye map.
    cam = Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=64, W=64, fx=40.0, fy=40.0,
        cx=32.0, cy=32.0, dist=jnp.array([0.03, -0.004, 0.0, 0.0, 0.0]),
        camera_model="fisheye",
    )
    means = jnp.array([[0.0, 0.0, 3.0], [1.5, 0.5, 2.5]])
    log_scales = jnp.full((2, 3), -2.0)
    quats = jnp.tile(jnp.array([1.0, 0.0, 0.0, 0.0]), (2, 1))
    opac = jnp.array([0.95, 0.9])
    colors = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    img = np.asarray(
        render_gaussians(
            means, log_scales, quats, opac, colors, cam,
            config=RenderConfig(raster_impl="xla"),
        )
    )
    assert np.all(np.isfinite(img))
    assert img[32, 32, 0] > 0.5  # red splat at center
    assert img[32, 32, 1] < img[32, 32, 0]


def test_fisheye_gradients_finite():
    cam = Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=32, W=32, fx=20.0, fy=20.0,
        cx=16.0, cy=16.0, dist=jnp.array([0.05, 0.0, 0.0, 0.0, 0.0]),
        camera_model="fisheye",
    )
    log_scales = jnp.full((3, 3), -1.5)
    quats = jnp.tile(jnp.array([1.0, 0.0, 0.0, 0.0]), (3, 1))
    opac = jnp.array([0.9, 0.8, 0.7])
    colors = jnp.ones((3, 3)) * 0.6
    # Includes an exactly on-axis gaussian (the lens map's removable
    # singularity) and a behind-camera one (UT dummy-lane sanitization).
    means = jnp.array(
        [[0.0, 0.0, 2.0], [0.4, -0.2, 1.5], [0.1, 0.1, -1.0]]
    )

    def loss(m, ls, q, o, c):
        img = render_gaussians(
            m, ls, q, o, c, cam, config=RenderConfig(raster_impl="xla")
        )
        return jnp.sum(img**2)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        means, log_scales, quats, opac, colors
    )
    for g in grads:
        assert np.all(np.isfinite(np.asarray(g)))
    # The visible gaussians must actually receive position gradient.
    assert np.abs(np.asarray(grads[0][:2])).max() > 0


def test_fisheye_wide_angle_stays_on_sensor():
    # ~80 deg off-axis: pinhole would project at tan(80deg)*f ~ 5.7*f px off
    # center; equidistant keeps it at theta*f ~ 1.4*f. With f chosen so the
    # sensor spans ~2.9 rad, the point lands on-screen.
    cam = Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=600, W=600, fx=200.0, fy=200.0,
        cx=300.0, cy=300.0, camera_model="fisheye",
    )
    pts = np.array([[np.tan(np.deg2rad(80.0)), 0.0, 1.0]])
    means, log_scales, quats, opac = tiny_gaussians(pts)
    res = project_gaussians(
        means, log_scales, quats, opac, cam, RenderConfig()
    )
    u = float(res.means2d[0, 0])
    expected = 200.0 * np.deg2rad(80.0) + 300.0
    np.testing.assert_allclose(u, expected, atol=0.05)
    assert res.radii[0, 0] > 0  # visible — not culled by the viewport test


def _surfel_scene(n=40, seed=3):
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 5)
    means = jax.random.normal(ks[0], (n, 3)) * jnp.array([0.6, 0.6, 0.3])
    means = means.at[:, 2].add(2.5)
    log_scales = jax.random.uniform(ks[1], (n, 2), minval=-2.5, maxval=-1.0)
    quats = jax.random.normal(ks[2], (n, 4))
    opac = jax.random.uniform(ks[3], (n,), minval=0.4, maxval=0.95)
    colors = jax.random.uniform(ks[4], (n, 3))
    return means, log_scales, quats, opac, colors


def test_surfels_reject_fisheye_on_pallas():
    # Surfels have no kernel: they render through the XLA route only, and
    # asking for the 3DGS kernels is an error, never a silent fallback.
    from mojosplat_jax.surfel import render_surfels

    cam = make_camera(H=32, W=32)
    means, log_scales, quats, opac, colors = _surfel_scene(n=2)
    cfg = RenderConfig(raster_impl="pallas", pallas_interpret=True,
                       tile_capacity=128)
    with pytest.raises(ValueError, match="XLA route only"):
        render_surfels(means, log_scales, quats, opac, colors, cam,
                       config=cfg)


def test_surfel_ortho_depth_invariance():
    """Under ortho, translating the scene along +z changes nothing but the
    depth map (parallel rays: no perspective scaling)."""
    from mojosplat_jax.surfel import render_surfels

    means, log_scales, quats, opac, colors = _surfel_scene()
    cam = Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=32, W=48,
        fx=12.0, fy=12.0, cx=24.0, cy=16.0, camera_model="ortho",
        far=1000.0,
    )
    img1, d1, aux1 = render_surfels(
        means, log_scales, quats, opac, colors, cam, return_depth=True,
        return_aux=True,
    )
    img2, d2 = render_surfels(
        means.at[:, 2].add(5.0), log_scales, quats, opac, colors, cam,
        return_depth=True,
    )
    np.testing.assert_allclose(
        np.asarray(img1), np.asarray(img2), atol=1e-5, rtol=1e-5
    )
    # Blended depth is sum(w z): shifting every z by 5 shifts it by
    # exactly 5 * coverage = 5 * (1 - final transmittance).
    coverage = 1.0 - np.asarray(aux1.raster.final_transmittance)
    assert coverage.max() > 0.3
    np.testing.assert_allclose(
        np.asarray(d2 - d1), 5.0 * coverage, atol=2e-4
    )


def test_surfel_fisheye_matches_pinhole_near_axis():
    """Ideal equidistant (k=0) surfel rays agree with pinhole rays to
    O(theta^3); at a long focal length the two renders match closely."""
    from mojosplat_jax.surfel import render_surfels

    means, log_scales, quats, opac, colors = _surfel_scene()
    kw = dict(H=32, W=48, fx=400.0, fy=400.0, cx=24.0, cy=16.0)
    cam_pin = Camera.create(R=jnp.eye(3), T=jnp.zeros(3), **kw)
    cam_fish = Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), **kw, camera_model="fisheye"
    )
    img_pin = render_surfels(means, log_scales, quats, opac, colors,
                             cam_pin)
    img_fish = render_surfels(means, log_scales, quats, opac, colors,
                              cam_fish)
    np.testing.assert_allclose(
        np.asarray(img_pin), np.asarray(img_fish), atol=5e-3
    )
    assert float(jnp.abs(img_pin).max()) > 0.01


def test_surfel_equidistant_inverse_roundtrip():
    from mojosplat_jax.surfel import _invert_equidistant
    from mojosplat_jax.ops.projection import apply_lens

    cam = make_camera(dist=jnp.array([0.03, -0.01, 0.004, -0.001, 0.0]))
    xn = jnp.linspace(-0.8, 0.8, 9)
    yn = jnp.linspace(-0.6, 0.6, 9)
    xd, yd = apply_lens(cam, xn, yn)
    xr, yr = _invert_equidistant(cam, xd, yd)
    np.testing.assert_allclose(np.asarray(xr), np.asarray(xn), atol=1e-5)
    np.testing.assert_allclose(np.asarray(yr), np.asarray(yn), atol=1e-5)


def test_surfel_fisheye_maps_and_gradients_finite():
    from mojosplat_jax.surfel import render_surfels

    means, log_scales, quats, opac, colors = _surfel_scene(n=20)
    cam = make_camera(H=32, W=32)

    def loss(m):
        img, depth, normal, dist = render_surfels(
            m, log_scales, quats, opac, colors, cam,
            return_depth=True, return_normals=True, return_distortion=True,
        )
        return (jnp.sum(img**2) + jnp.sum(depth**2) * 1e-3
                + jnp.sum(normal**2) * 1e-3 + jnp.sum(dist**2) * 1e-3)

    g = jax.grad(loss)(means)
    assert np.all(np.isfinite(np.asarray(g)))


def test_colmap_fisheye_model_mapping():
    from mojosplat_jax.utils.colmap import ColmapCamera, camera_intrinsics

    # OPENCV_FISHEYE (5): fx, fy, cx, cy, k1, k2, k3, k4
    cam = ColmapCamera(1, 5, 640, 480,
                       np.array([500.0, 505.0, 320.0, 240.0,
                                 0.08, -0.01, 0.002, -0.0005]))
    fx, fy, cx, cy, W, H, dist, model = camera_intrinsics(cam)
    assert model == "fisheye" and (fx, fy) == (500.0, 505.0)
    np.testing.assert_allclose(dist[:4], [0.08, -0.01, 0.002, -0.0005],
                               rtol=1e-6)
    assert dist[4] == 0.0

    # SIMPLE_RADIAL_FISHEYE (8): f, cx, cy, k
    cam8 = ColmapCamera(1, 8, 640, 480,
                        np.array([500.0, 320.0, 240.0, 0.05]))
    *_, dist8, model8 = camera_intrinsics(cam8)
    assert model8 == "fisheye" and dist8[0] == np.float32(0.05)
    assert np.all(dist8[1:] == 0)

    # RADIAL_FISHEYE (9): f, cx, cy, k1, k2
    cam9 = ColmapCamera(1, 9, 640, 480,
                        np.array([500.0, 320.0, 240.0, 0.05, -0.01]))
    *_, dist9, model9 = camera_intrinsics(cam9)
    assert model9 == "fisheye"
    np.testing.assert_allclose(dist9[:2], [0.05, -0.01], rtol=1e-6)


# ---------------------------------------------------------------------------
# Orthographic camera model
# ---------------------------------------------------------------------------


def make_ortho_camera(H=64, W=64, fx=20.0, fy=22.0):
    return Camera.create(
        R=jnp.eye(3), T=jnp.zeros(3), H=H, W=W, fx=fx, fy=fy,
        cx=W / 2.0, cy=H / 2.0, camera_model="ortho",
    )


def test_ortho_projection_closed_form():
    # u = fx*x + cx independent of depth; conic of an axis-aligned gaussian
    # is diag(1/(fx*sx)^2-ish) independent of depth too.
    cam = make_ortho_camera()
    pts = np.array([[0.5, -0.4, 2.0], [0.5, -0.4, 9.0], [0.0, 0.0, 5.0]])
    means, log_scales, quats, opac = tiny_gaussians(pts)
    res = project_gaussians(
        means, log_scales, quats, opac, cam, RenderConfig()
    )
    expected = np.stack(
        [20.0 * pts[:, 0] + 32.0, 22.0 * pts[:, 1] + 32.0], axis=-1
    )
    np.testing.assert_allclose(np.asarray(res.means2d), expected, atol=1e-5)
    # Same (x, y), different z: identical screen position and conic.
    np.testing.assert_allclose(
        np.asarray(res.means2d[0]), np.asarray(res.means2d[1]), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(res.conics[0]), np.asarray(res.conics[1]), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(res.depths), pts[:, 2], atol=1e-6
    )


def test_ortho_ewa_matches_ut():
    # The ortho map is affine, so both modes are exact and must agree.
    cam = make_ortho_camera()
    rng = np.random.default_rng(3)
    n = 64
    means = jnp.asarray(
        np.concatenate(
            [rng.normal(0, 0.8, (n, 2)), rng.uniform(1.0, 9.0, (n, 1))],
            axis=1,
        ),
        jnp.float32,
    )
    log_scales = jnp.asarray(rng.normal(-2.0, 0.3, (n, 3)), jnp.float32)
    quats = jnp.asarray(rng.normal(size=(n, 4)), jnp.float32)
    opac = jnp.full((n,), 0.8)
    r_ewa = project_gaussians(
        means, log_scales, quats, opac, cam, RenderConfig()
    )
    r_ut = project_gaussians(
        means, log_scales, quats, opac, cam,
        RenderConfig(projection_mode="ut"),
    )
    np.testing.assert_allclose(
        np.asarray(r_ewa.means2d), np.asarray(r_ut.means2d),
        atol=1e-3, rtol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(r_ewa.conics), np.asarray(r_ut.conics),
        atol=1e-3, rtol=2e-3,
    )


def test_ortho_render_smoke_and_gradients():
    cam = make_ortho_camera(H=48, W=48, fx=15.0, fy=15.0)
    means = jnp.array([[0.0, 0.0, 3.0], [1.0, -0.5, 6.0]])
    log_scales = jnp.full((2, 3), -1.8)
    quats = jnp.tile(jnp.array([1.0, 0.0, 0.0, 0.0]), (2, 1))
    opac = jnp.array([0.95, 0.9])
    colors = jnp.array([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])

    def loss(m):
        img = render_gaussians(
            m, log_scales, quats, opac, colors, cam,
            config=RenderConfig(raster_impl="xla"),
        )
        return jnp.sum(img**2), img

    (val, img), g = jax.value_and_grad(loss, has_aux=True)(means)
    img = np.asarray(img)
    assert np.all(np.isfinite(img))
    assert img[24, 24, 0] > 0.5  # red splat at the principal point
    assert np.all(np.isfinite(np.asarray(g))) and np.abs(g).max() > 0
