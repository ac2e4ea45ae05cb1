"""2DGS surfel family tests: exact ray/disk response, low-pass filter,
equivalence with a flattened 3DGS gaussian, depth/normal maps, gradients."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax.surfel import render_surfels, surfel_alpha_data

CFG = RenderConfig(tile_capacity=128, chunk_size=32)


def make_camera(H=64, W=64, fx=100.0):
    return Camera.create(
        R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
        H=H, W=W, fx=fx, fy=fx, cx=W / 2, cy=H / 2,
    )


def one_surfel(z=2.0, s=0.2, opacity=0.9, color=(1.0, 0.0, 0.0),
               quat=(1.0, 0.0, 0.0, 0.0), fx=100.0, on_pixel_center=False):
    # on_pixel_center shifts the disk so it projects EXACTLY onto the
    # center pixel's +0.5 sample point (rasterization.mojo:78-79).
    off = 0.5 * z / fx if on_pixel_center else 0.0
    return dict(
        means3d=jnp.array([[off, off, z]]),
        scales=jnp.full((1, 2), math.log(s)),
        quats=jnp.array([list(quat)]),
        opacities=jnp.array([opacity]),
        features=jnp.array([list(color)]),
    )


def test_face_on_disk_center_alpha():
    cam = make_camera()
    img, aux = render_surfels(
        **one_surfel(opacity=0.9, on_pixel_center=True), camera=cam,
        config=CFG, return_aux=True,
    )
    cy, cx = cam.H // 2, cam.W // 2
    alpha = 1.0 - float(aux.raster.final_transmittance[cy, cx])
    np.testing.assert_allclose(alpha, 0.9, atol=1e-3)
    np.testing.assert_allclose(float(img[cy, cx, 0]), 0.9, atol=1e-3)
    assert float(img[0, 0, 0]) == 0.0  # corners untouched


def test_face_on_profile_matches_formula():
    # Face-on disk: u = dx * z / (fx * s), so the response at pixel offset
    # dpx from center is exp(-dpx^2 z^2 / (2 fx^2 s^2)).
    z, s, f, op = 2.0, 0.3, 100.0, 0.8
    cam = make_camera(fx=f)
    img, aux = render_surfels(
        **one_surfel(z=z, s=s, opacity=op, fx=f, on_pixel_center=True),
        camera=cam, config=CFG, return_aux=True,
    )
    cy, cx = cam.H // 2, cam.W // 2
    for dpx in (3, 7, 11):
        alpha = 1.0 - float(aux.raster.final_transmittance[cy, cx + dpx])
        # pixel center offset is dpx exactly (both at +0.5)
        expected = op * math.exp(-(dpx**2) * z**2 / (2 * f**2 * s**2))
        np.testing.assert_allclose(alpha, expected, rtol=2e-2, atol=1e-3)


def test_surfel_matches_flattened_3dgs():
    # A 3DGS gaussian with a near-zero third axis IS a surfel (up to the
    # different low-pass: EWA dilates by eps2d, 2DGS maxes with a 0.7 px
    # filter) — images must agree closely for a well-resolved face-on disk.
    cam = make_camera()
    sp = one_surfel(z=2.0, s=0.25, opacity=0.85, color=(0.2, 0.9, 0.4))
    img_s = render_surfels(**sp, camera=cam, config=CFG)
    g = dict(sp)
    g["scales"] = jnp.concatenate(
        [sp["scales"], jnp.full((1, 1), -13.8)], axis=-1
    )
    img_g = render_gaussians(**g, camera=cam, config=CFG)
    assert float(jnp.mean(jnp.abs(img_s - img_g))) < 5e-3


def test_edge_on_disk_visible_via_filter():
    # 90 deg rotation about x: the disk becomes edge-on; the exact
    # intersection response vanishes but the low-pass filter keeps a
    # ~pixel-wide footprint alive (the paper's degenerate-case fix).
    q = (math.cos(math.pi / 4), math.sin(math.pi / 4), 0.0, 0.0)
    cam = make_camera()
    img, aux = render_surfels(**one_surfel(quat=q, opacity=0.9), camera=cam,
                              config=CFG, return_aux=True)
    cy, cx = cam.H // 2, cam.W // 2
    alpha_c = 1.0 - float(aux.raster.final_transmittance[cy, cx])
    assert alpha_c > 0.5  # filter keeps the center visible
    assert np.all(np.isfinite(np.asarray(img)))
    # But the footprint is tiny compared to face-on.
    cover = float(jnp.sum(1.0 - aux.raster.final_transmittance > 0.01))
    img_f, aux_f = render_surfels(**one_surfel(opacity=0.9), camera=cam,
                                  config=CFG, return_aux=True)
    cover_f = float(jnp.sum(1.0 - aux_f.raster.final_transmittance > 0.01))
    assert cover < 0.35 * cover_f


def test_depth_and_normal_maps():
    cam = make_camera()
    img, depth, normal, aux = render_surfels(
        **one_surfel(z=2.0, opacity=0.95), camera=cam, config=CFG,
        return_aux=True, return_depth=True, return_normals=True,
    )
    cy, cx = cam.H // 2, cam.W // 2
    alpha = 1.0 - float(aux.raster.final_transmittance[cy, cx])
    np.testing.assert_allclose(float(depth[cy, cx]) / alpha, 2.0, rtol=1e-4)
    n = np.asarray(normal[cy, cx]) / alpha
    np.testing.assert_allclose(n, [0.0, 0.0, -1.0], atol=1e-3)


def test_surfel_gradients_finite():
    rng = np.random.default_rng(7)
    n = 100
    cam = make_camera()
    p = dict(
        means3d=jnp.asarray(np.concatenate(
            [rng.normal(0, 0.4, (n, 2)), rng.uniform(1.5, 4.0, (n, 1))],
            axis=1).astype(np.float32)),
        scales=jnp.asarray(rng.normal(-1.8, 0.3, (n, 2)).astype(np.float32)),
        quats=jnp.asarray(rng.normal(0, 1, (n, 4)).astype(np.float32)),
        opacities=jnp.asarray(rng.uniform(0.3, 0.9, n).astype(np.float32)),
        features=jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
    )

    def loss(q):
        img = render_surfels(
            q["means3d"], q["scales"], q["quats"], q["opacities"],
            q["features"], cam, config=CFG,
            background_color=jnp.array([0.1, 0.1, 0.1]),
        )
        return jnp.mean(img**2)

    g = jax.grad(loss)(p)
    for k, v in g.items():
        assert np.all(np.isfinite(np.asarray(v))), k
    assert float(jnp.linalg.norm(g["means3d"])) > 0


def test_surfel_alpha_data_shapes():
    cam = make_camera()
    p = one_surfel()
    d = surfel_alpha_data(p["means3d"], p["scales"], p["quats"],
                          p["opacities"], cam)
    assert d.shape == (1, 12)
    np.testing.assert_allclose(np.asarray(d[0, 0:3]), [0.0, 0.0, 2.0])


def _random_surfel_scene(n=150, seed=5):
    rng = np.random.default_rng(seed)
    return dict(
        means3d=jnp.asarray(np.concatenate(
            [rng.normal(0, 0.4, (n, 2)), rng.uniform(1.5, 4.0, (n, 1))],
            axis=1).astype(np.float32)),
        scales=jnp.asarray(rng.normal(-1.8, 0.3, (n, 2)).astype(np.float32)),
        quats=jnp.asarray(rng.normal(0, 1, (n, 4)).astype(np.float32)),
        opacities=jnp.asarray(rng.uniform(0.3, 0.9, n).astype(np.float32)),
        features=jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
    )


def test_normal_consistency_loss_flat_wall():
    # A flat face-on wall of surfels: rendered normals and depth-implied
    # normals both equal (0,0,-1), so the loss is ~0; rotating every surfel
    # 45 degrees away raises it.
    from mojosplat_jax.surfel import normal_consistency_loss

    cam = make_camera()
    rng = np.random.default_rng(9)
    n = 400
    xy = rng.uniform(-0.7, 0.7, (n, 2)).astype(np.float32)
    p = dict(
        means3d=jnp.asarray(np.c_[xy, np.full((n, 1), 2.0, np.float32)]),
        scales=jnp.full((n, 2), math.log(0.12)),
        quats=jnp.tile(jnp.array([[1.0, 0.0, 0.0, 0.0]]), (n, 1)),
        opacities=jnp.full((n,), 0.95),
        features=jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
    )
    img, depth, normal, aux = render_surfels(
        **p, camera=cam, config=CFG, return_aux=True, return_depth=True,
        return_normals=True,
    )
    loss_flat = float(normal_consistency_loss(
        depth, normal, aux.raster.final_transmittance, cam
    ))
    a = math.pi / 8
    p_rot = dict(p, quats=jnp.tile(
        jnp.array([[math.cos(a), math.sin(a), 0.0, 0.0]]), (n, 1)
    ))
    img, depth, normal, aux = render_surfels(
        **p_rot, camera=cam, config=CFG, return_aux=True, return_depth=True,
        return_normals=True,
    )
    loss_rot = float(normal_consistency_loss(
        depth, normal, aux.raster.final_transmittance, cam
    ))
    assert loss_flat < 0.02
    assert loss_rot > loss_flat + 0.02
    # Differentiable wrt surfel parameters.
    def f(quats):
        _i, d, nm, ax = render_surfels(
            **dict(p, quats=quats), camera=cam, config=CFG,
            return_aux=True, return_depth=True, return_normals=True,
        )
        return normal_consistency_loss(
            d, nm, ax.raster.final_transmittance, cam
        )
    g = jax.grad(f)(p["quats"])
    assert np.all(np.isfinite(np.asarray(g)))


def test_normal_consistency_tilted_wall():
    # A tilted wall tiled by many SMALL surfels: the center depths trace the
    # tilt, so the depth-backprojected normals match the surfel normals and
    # the correctly-oriented wall scores lower than a mis-oriented one —
    # the regime where the center-depth approximation is valid (see the
    # loss docstring caveat).
    from mojosplat_jax.surfel import normal_consistency_loss

    cam = make_camera()
    rng = np.random.default_rng(3)
    n = 600
    xy = rng.uniform(-0.8, 0.8, (n, 2)).astype(np.float32)
    tilt = math.pi / 8  # rotate wall about the y axis
    # Rotation about +y by -tilt maps the disk normal (0,0,1) to
    # (-sin t, 0, cos t) — the normal of the plane z = 2 + tan(t) x.
    qw = (math.cos(tilt / 2), 0.0, -math.sin(tilt / 2), 0.0)
    z = 2.0 + np.tan(tilt) * xy[:, 0]
    base = dict(
        means3d=jnp.asarray(np.c_[xy, z].astype(np.float32)),
        scales=jnp.full((n, 2), math.log(0.08)),
        opacities=jnp.full((n,), 0.95),
        features=jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
    )

    def loss_for(quat):
        img, depth, normal, aux = render_surfels(
            **base, quats=jnp.tile(jnp.array([list(quat)]), (n, 1)),
            camera=cam, config=CFG, return_aux=True, return_depth=True,
            return_normals=True,
        )
        return float(normal_consistency_loss(
            depth, normal, aux.raster.final_transmittance, cam
        ))

    loss_correct = loss_for(qw)  # disks lie in the tilted plane
    loss_wrong = loss_for((1.0, 0.0, 0.0, 0.0))  # face-on disks on a tilt
    assert loss_correct < 0.06
    assert loss_wrong > loss_correct + 0.01


def test_edge_on_filter_footprint_not_tile_truncated():
    # Regression (code review): the EWA radius alone (~1.8 px on the thin
    # axis) under-covered the low-pass filter's ~2.3 px support, truncating
    # an edge-on surfel's footprint at tile borders. Place the disk right at
    # a tile boundary and check the filter tail lands on both sides.
    q = (math.cos(math.pi / 4), math.sin(math.pi / 4), 0.0, 0.0)  # edge-on
    cam = make_camera()
    # Tile boundary at x = 32 px; put the center at x = 31.8 px.
    z = 2.0
    x_world = (31.8 - 32.0) / 100.0 * z  # px -> world at depth z
    p = one_surfel(z=z, s=0.3, opacity=0.95, quat=q)
    p["means3d"] = jnp.array([[x_world, 0.0, z]])
    img, aux = render_surfels(**p, camera=cam, config=CFG, return_aux=True)
    alpha = 1.0 - np.asarray(aux.raster.final_transmittance)
    row = alpha[32]
    # Pixels on BOTH sides of the boundary catch the filter tail.
    assert row[31] > 1e-3 and row[32] > 1e-3 and row[33] > 1e-3


def test_intersection_depth_traces_tilt_within_one_surfel():
    # The depth channel is the per-pixel ray/disk intersection depth: a
    # SINGLE tilted surfel's expected depth varies across its interior with
    # the plane's slope (the center-depth approximation would be constant).
    tilt = math.pi / 6
    q = (math.cos(tilt / 2), 0.0, -math.sin(tilt / 2), 0.0)
    cam = make_camera()
    p = one_surfel(z=2.0, s=0.5, opacity=0.95, quat=q)
    img, depth, aux = render_surfels(
        **p, camera=cam, config=CFG, return_aux=True, return_depth=True,
    )
    alpha = 1.0 - np.asarray(aux.raster.final_transmittance)
    d = np.asarray(depth)
    cy, cx = cam.H // 2, cam.W // 2
    # Expected depth along the center row follows z = 2 + tan(tilt) * x_world,
    # with x_world = (px + .5 - cx)/fx * z (solve: z = 2 / (1 - tan*xn)).
    for dpx in (-8, 0, 8):
        xn = (cx + dpx + 0.5 - 32.0) / 100.0
        expected = 2.0 / (1.0 - math.tan(tilt) * xn)
        got = d[cy, cx + dpx] / alpha[cy, cx + dpx]
        np.testing.assert_allclose(got, expected, rtol=1e-3)


def test_depth_distortion_map():
    # Two stacked translucent face-on disks at z=2 and z=3: covered pixels
    # have depth spread ~ 2 w2 w3 (z3-z2)^2; a single disk has ~zero.
    cam = make_camera()
    two = dict(
        means3d=jnp.array([[0.0, 0.0, 2.0], [0.0, 0.0, 3.0]]),
        scales=jnp.full((2, 2), math.log(0.3)),
        quats=jnp.array([[1.0, 0.0, 0.0, 0.0]] * 2),
        opacities=jnp.array([0.5, 0.9]),
        features=jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]),
    )
    img, dist, aux = render_surfels(
        **two, camera=cam, config=CFG, return_aux=True,
        return_distortion=True,
    )
    cy, cx = cam.H // 2, cam.W // 2
    # center weights: w1 = 0.5, w2 = (1-0.5)*0.9 = 0.45
    expected = 2.0 * 0.5 * 0.45 * (3.0 - 2.0) ** 2
    np.testing.assert_allclose(float(dist[cy, cx]), expected, rtol=2e-2)
    one = {k: v[:1] for k, v in two.items()}
    _img, dist1 = render_surfels(
        **one, camera=cam, config=CFG, return_distortion=True,
    )
    assert abs(float(dist1[cy, cx])) < 1e-4


def test_surfel_pallas_viewport_rows_parity():
    # A mid-image slab (the sharded renderer's primitive) must equal the
    # matching rows of the full-frame render; surfels shift the slab back
    # to absolute pixel coordinates inside the alpha model.
    cam = make_camera()
    p = _random_surfel_scene(n=120, seed=8)
    kw = dict(camera=cam, viewport_rows=(32, 32),
              background_color=jnp.array([0.15, 0.05, 0.2]))
    img_x = render_surfels(
        **p, **kw, config=RenderConfig(tile_capacity=128, chunk_size=32)
    )
    assert img_x.shape == (32, 64, 3)
    full = render_surfels(
        **p, camera=cam, background_color=jnp.array([0.15, 0.05, 0.2]),
        config=RenderConfig(tile_capacity=128, chunk_size=32),
    )
    np.testing.assert_allclose(
        np.asarray(img_x), np.asarray(full[32:64]), atol=2e-5
    )
