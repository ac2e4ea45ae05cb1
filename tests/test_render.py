"""End-to-end render tests (reference analogue: /root/reference/tests/
test_render.py, plus the SH path the reference cannot exercise)."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax.ops.sh import num_sh_bases

CFG = RenderConfig(tile_capacity=128, chunk_size=32)


def make_camera(H=64, W=64, fx=100.0):
    return Camera.create(
        R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
        H=H, W=W, fx=fx, fy=fx, cx=W / 2, cy=H / 2,
    )


def one_gaussian(color=(1.0, 0.0, 0.0), z=2.0, opacity=0.9):
    return dict(
        means3d=jnp.array([[0.0, 0.0, z]]),
        scales=jnp.full((1, 3), -1.5),
        quats=jnp.array([[1.0, 0.0, 0.0, 0.0]]),
        opacities=jnp.array([opacity]),
        features=jnp.array([list(color)]),
    )


def test_output_shape_dtype():
    # (test_render.py:38-54)
    cam = make_camera()
    img = render_gaussians(**one_gaussian(), camera=cam, config=CFG)
    assert img.shape == (cam.H, cam.W, 3)
    assert img.dtype == jnp.float32
    assert np.all(np.isfinite(np.asarray(img)))


def test_center_red_corners_background():
    # (test_render.py:60-86)
    cam = make_camera()
    bg = jnp.array([0.0, 0.0, 0.2])
    img = render_gaussians(
        **one_gaussian(), camera=cam, background_color=bg, config=CFG
    )
    img = np.asarray(img)
    assert img[32, 32, 0] > 0.5
    for corner in [img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]]:
        np.testing.assert_allclose(corner, np.asarray(bg), atol=1e-4)


def test_two_gaussians_both_visible():
    # (test_render.py:88-119)
    cam = make_camera()
    img = render_gaussians(
        means3d=jnp.array([[-0.5, 0.0, 2.0], [0.5, 0.0, 2.0]]),
        scales=jnp.full((2, 3), -1.8),
        quats=jnp.tile(jnp.array([[1.0, 0.0, 0.0, 0.0]]), (2, 1)),
        opacities=jnp.array([0.9, 0.9]),
        features=jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
        camera=cam,
        config=CFG,
    )
    img = np.asarray(img)
    assert img[:, :32, 0].max() > 0.5  # red on the left
    assert img[:, 32:, 1].max() > 0.5  # green on the right


@pytest.mark.parametrize("degree", [0, 1, 3])
def test_sh_rendering(degree):
    # Closes the reference's SH TODO (render.py:82-87). Degree-0 SH with
    # sh0 = (rgb - 0.5)/C0 must reproduce the direct RGB render exactly.
    C0 = 0.28209479177387814
    cam = make_camera()
    rgb = jnp.array([[0.8, 0.3, 0.6]])
    K = num_sh_bases(degree)
    sh = jnp.zeros((1, K, 3)).at[:, 0, :].set((rgb - 0.5) / C0)
    base = one_gaussian()
    img_rgb = render_gaussians(
        **{**base, "features": rgb}, camera=cam, config=CFG
    )
    img_sh = render_gaussians(
        **{**base, "features": sh}, camera=cam, sh_degree=degree, config=CFG
    )
    np.testing.assert_allclose(
        np.asarray(img_sh), np.asarray(img_rgb), atol=1e-5
    )


def test_sh_view_dependence():
    # Nonzero band-1 coefficients make color vary with viewing direction.
    cam = make_camera()
    K = num_sh_bases(1)
    sh = jnp.zeros((1, K, 3)).at[:, 0, :].set(0.5).at[:, 3, 0].set(1.0)
    base = one_gaussian()
    img_a = render_gaussians(
        **{**base, "features": sh,
           "means3d": jnp.array([[-0.4, 0.0, 2.0]])},
        camera=cam, sh_degree=1, config=CFG,
    )
    img_b = render_gaussians(
        **{**base, "features": sh,
           "means3d": jnp.array([[0.4, 0.0, 2.0]])},
        camera=cam, sh_degree=1, config=CFG,
    )
    red_a = np.asarray(img_a)[..., 0].max()
    red_b = np.asarray(img_b)[..., 0].max()
    assert abs(red_a - red_b) > 0.05


def test_return_aux():
    cam = make_camera()
    img, aux = render_gaussians(
        **one_gaussian(), camera=cam, config=CFG, return_aux=True
    )
    assert int(aux.binning.num_isects) > 0
    assert int(aux.binning.capacity_overflow) == 0
    assert aux.raster.final_transmittance.shape == (cam.H, cam.W)


def test_input_validation():
    cam = make_camera()
    base = one_gaussian()
    with pytest.raises(ValueError):
        render_gaussians(
            **{**base, "opacities": jnp.ones((1, 1))}, camera=cam, config=CFG
        )
    with pytest.raises(ValueError):
        render_gaussians(
            **base, camera=cam, background_color=jnp.zeros(4), config=CFG
        )
    with pytest.raises(ValueError):  # SH features without sh_degree
        render_gaussians(
            **{**base, "features": jnp.zeros((1, 9, 3))}, camera=cam, config=CFG
        )


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_antialiased_mode(impl):
    # Mip-Splatting opacity compensation: a small (near-pixel-scale) splat
    # renders dimmer in antialiased mode (its eps2d-dilated footprint no
    # longer inflates energy); a large splat is nearly unchanged.
    cam = make_camera()
    cfg_aa = RenderConfig(
        tile_capacity=128, chunk_size=32, raster_impl=impl,
        pallas_interpret=(impl == "pallas"), antialiased=True,
    )
    cfg_classic = RenderConfig(
        tile_capacity=128, chunk_size=32, raster_impl=impl,
        pallas_interpret=(impl == "pallas"),
    )
    small = one_gaussian()
    small["scales"] = jnp.full((1, 3), -4.5)  # ~sub-pixel on screen
    img_aa = np.asarray(render_gaussians(**small, camera=cam, config=cfg_aa))
    img_cl = np.asarray(
        render_gaussians(**small, camera=cam, config=cfg_classic)
    )
    assert img_aa[:, :, 0].max() < img_cl[:, :, 0].max() * 0.6

    big = one_gaussian()  # scale e^-1.5 at z=2, f=100 => ~11 px sigma
    img_aa = np.asarray(render_gaussians(**big, camera=cam, config=cfg_aa))
    img_cl = np.asarray(render_gaussians(**big, camera=cam, config=cfg_classic))
    np.testing.assert_allclose(img_aa, img_cl, atol=5e-3)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_depth_rendering(impl):
    # Accumulated depth map via the kernels' aux channel (gsplat 'D'/'ED'
    # render modes). Expected depth at the splat center ~= its camera z.
    cam = make_camera()
    cfg = RenderConfig(
        tile_capacity=128, chunk_size=32, raster_impl=impl,
        pallas_interpret=(impl == "pallas"),
    )
    img, depth, aux = render_gaussians(
        **one_gaussian(z=2.0, opacity=0.95), camera=cam, config=cfg,
        return_depth=True, return_aux=True,
    )
    assert img.shape == (cam.H, cam.W, 3)
    assert depth.shape == (cam.H, cam.W)
    alpha = 1.0 - np.asarray(aux.raster.final_transmittance)
    d = np.asarray(depth)
    cy, cx = cam.H // 2, cam.W // 2
    expected_center = d[cy, cx] / max(alpha[cy, cx], 1e-9)
    np.testing.assert_allclose(expected_center, 2.0, rtol=1e-4)
    # Pixels the splat misses accumulate no depth.
    assert d[0, 0] == 0.0 and alpha[0, 0] == 0.0


def test_depth_parity_xla_vs_pallas():
    rng = np.random.default_rng(11)
    n = 200
    means = np.concatenate(
        [rng.normal(0, 0.4, (n, 2)), rng.uniform(1.5, 5.0, (n, 1))], axis=1
    ).astype(np.float32)
    scales = rng.normal(-1.8, 0.2, (n, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, n).astype(np.float32)
    feats = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    cam = make_camera()
    args = dict(
        means3d=jnp.asarray(means), scales=jnp.asarray(scales),
        quats=jnp.asarray(quats), opacities=jnp.asarray(opac),
        features=jnp.asarray(feats), camera=cam,
        background_color=jnp.array([0.2, 0.1, 0.3]), return_depth=True,
    )
    img_x, dep_x = render_gaussians(
        **args, config=RenderConfig(tile_capacity=128, chunk_size=32)
    )
    img_p, dep_p = render_gaussians(
        **args,
        config=RenderConfig(
            tile_capacity=128, chunk_size=32, raster_impl="pallas",
            pallas_interpret=True,
        ),
    )
    np.testing.assert_allclose(
        np.asarray(img_p), np.asarray(img_x), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(dep_p), np.asarray(dep_x), atol=1e-4
    )


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_depth_gradients(impl):
    # Depth supervision must backprop to gaussian positions: moving the
    # gaussian farther increases the rendered depth.
    cam = make_camera()
    cfg = RenderConfig(
        tile_capacity=128, chunk_size=32, raster_impl=impl,
        pallas_interpret=(impl == "pallas"),
    )
    g = one_gaussian(z=2.0, opacity=0.95)

    def center_expected_depth(means3d):
        _img, depth, aux = render_gaussians(
            means3d, g["scales"], g["quats"], g["opacities"], g["features"],
            cam, config=cfg, return_depth=True, return_aux=True,
        )
        alpha = 1.0 - aux.raster.final_transmittance[cam.H // 2, cam.W // 2]
        return depth[cam.H // 2, cam.W // 2] / alpha

    grad = jax.grad(center_expected_depth)(g["means3d"])
    assert np.all(np.isfinite(np.asarray(grad)))
    # Single gaussian: expected depth at its center IS its camera z, so
    # d/dz = 1 (x/y leave the center's expected depth unchanged: 0).
    np.testing.assert_allclose(float(grad[0, 2]), 1.0, atol=1e-4)
