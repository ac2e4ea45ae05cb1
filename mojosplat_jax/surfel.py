"""2D Gaussian Splatting (surfels): a second primitive family.

Implements the 2DGS model (Huang et al., "2D Gaussian Splatting for
Geometrically Accurate Radiance Fields", SIGGRAPH 2024): each primitive is a
flat elliptical disk — center ``p``, tangent axes ``t_u, t_v`` (first two
columns of the quaternion rotation), scales ``(s_u, s_v)`` — and a pixel's
response comes from the EXACT ray/disk intersection instead of a screen-space
conic. Well beyond the reference's surface (it implements 3DGS only), but a
standard capability of contemporary splatting frameworks.

Math (camera frame): with ``qc = R_c p + t_c``, ``a = s_u R_c t_u``,
``b = s_v R_c t_v``, the point hit by the pixel ray of normalized coords
``(xn, yn)`` solves the 2x2 system

    u (a_x - xn a_z) + v (b_x - xn b_z) = xn qc_z - qc_x
    u (a_y - yn a_z) + v (b_y - yn b_z) = yn qc_z - qc_y

and the surfel response is ``G = exp(-(u^2+v^2)/2)``. The paper's low-pass
filter — ``max(G, G_filter)`` with a fixed sigma = sqrt(2)/2 px screen-space
gaussian around the projected center — keeps edge-on disks visible.

Reuse of the 3DGS machinery:
  - culling / AABB radii / binning: the surfel is bounded by its own
    flattened 3D gaussian (third scale ~ 0), so projection + binning are
    *literally* `ops.projection.project_gaussians` / `ops.binning` on
    log-scales ``(s_u, s_v, tiny)``.
  - blending: `ops.rasterization.rasterize_xla_generic` with a surfel
    alpha_fn — the same chunked front-to-back recurrence, early exit and
    aux outputs as the 3DGS path.

Rendering runs through the XLA blender, which provides the full output
surface (RGB + per-pixel intersection depth / normal / distortion maps,
fwd+bwd), so 2DGS training runs with the paper's regularizers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .camera import Camera
from .config import DEFAULT_CONFIG, RenderConfig
from .ops.binning import bin_gaussians_to_tiles
from .ops.projection import project_gaussians
from .ops.rasterization import rasterize_xla_generic
from .ops.sh import sh_to_color
from .render import RenderAux

_FILTER_SIGMA2 = 0.5  # (sqrt(2)/2)^2 — the paper's screen-space low-pass
_TINY_LOG_SCALE = -13.8  # exp() ~ 1e-6: the disk's "thickness" for binning


def _rotate_rows(vx, vy, vz, R):
    """(R @ v) for per-gaussian column vectors, fully elementwise.

    ``v`` arrives as three (N,) columns; ``R`` is a (3, 3) camera rotation.
    Written as scalar-broadcast multiply-adds, so the whole prep chain is
    one elementwise fusion with no matrix product (and no TF32 rounding).
    """
    return (
        vx * R[0, 0] + vy * R[0, 1] + vz * R[0, 2],
        vx * R[1, 0] + vy * R[1, 1] + vz * R[1, 2],
        vx * R[2, 0] + vy * R[2, 1] + vz * R[2, 2],
    )


def _tangent_axes(quats):
    """First two rotation-matrix columns (the disk's tangent axes) straight
    from the wxyz quaternions — same normalize-first math as
    ops.projection.quat_to_rotmat, without building the (N, 3, 3) stack."""
    norm = jnp.linalg.norm(quats, axis=-1, keepdims=True)
    q = quats / jnp.maximum(norm, 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    tu = (1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y))
    tv = (2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x))
    return tu, tv


def surfel_alpha_columns(
    means3d: jax.Array,  # (N, 3)
    scales: jax.Array,  # (N, 2) or (N, 3) log scales (third ignored)
    quats: jax.Array,  # (N, 4) wxyz
    opacities: jax.Array,  # (N,)
    camera: Camera,
) -> tuple:
    """12 per-surfel (N,) field columns [qc(3), a(3), b(3), c2(2), opacity].

    One elementwise program from the raw parameters to the field columns
    (see _rotate_rows).
    """
    tu, tv = _tangent_axes(quats)
    su = jnp.exp(scales[:, 0])
    sv = jnp.exp(scales[:, 1])
    qcx, qcy, qcz = _rotate_rows(
        means3d[:, 0], means3d[:, 1], means3d[:, 2], camera.R
    )
    qcx, qcy, qcz = qcx + camera.T[0], qcy + camera.T[1], qcz + camera.T[2]
    ax, ay, az = _rotate_rows(*tu, camera.R)
    bx, by, bz = _rotate_rows(*tv, camera.R)
    if camera.camera_model == "ortho":
        # No z-divide: the low-pass filter center is the affine image of qc.
        c2x = camera.fx * qcx + camera.cx
        c2y = camera.fy * qcy + camera.cy
    else:
        z = jnp.maximum(qcz, 1e-6)
        xn, yn = qcx / z, qcy / z
        if camera.camera_model == "fisheye":
            from .ops.projection import apply_lens

            xn, yn = apply_lens(camera, xn, yn)
        c2x = camera.fx * xn + camera.cx
        c2y = camera.fy * yn + camera.cy
    return (
        qcx, qcy, qcz,
        su * ax, su * ay, su * az,
        sv * bx, sv * by, sv * bz,
        c2x,
        c2y,
        opacities,
    )


def surfel_alpha_data(
    means3d: jax.Array,  # (N, 3)
    scales: jax.Array,  # (N, 2) or (N, 3) log scales (third ignored)
    quats: jax.Array,  # (N, 4) wxyz
    opacities: jax.Array,  # (N,)
    camera: Camera,
) -> jax.Array:
    """(N, 12) per-surfel rows [qc(3), a(3), b(3), center2d(2), opacity]."""
    return jnp.stack(
        surfel_alpha_columns(means3d, scales, quats, opacities, camera),
        axis=-1,
    )


def oriented_normal_columns(columns) -> tuple:
    """(nx, ny, nz) viewer-oriented unit normal columns from the 12 surfel
    field columns (cross product of the camera-frame tangent axes, flipped
    toward the viewer — the paper flips by sign of n . dir)."""
    ax, ay, az, bx, by, bz = columns[3:9]
    nx = ay * bz - az * by
    ny = az * bx - ax * bz
    nz = ax * by - ay * bx
    inv = 1.0 / jnp.maximum(jnp.sqrt(nx * nx + ny * ny + nz * nz), 1e-12)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    flip = nz > 0
    return (jnp.where(flip, -nx, nx), jnp.where(flip, -ny, ny),
            jnp.where(flip, -nz, nz))


def _invert_equidistant(camera, xd, yd):
    """Inverse of apply_lens's fisheye map: distorted normalized coords ->
    undistorted normalized coords (i.e. the pixel's ray direction is
    (xn, yn, 1)). theta solves theta_d = theta (1 + k1 th^2 + ... + k4 th^8)
    by a fixed 8-step Newton iteration (exact in one step for the ideal
    k = 0 lens, where theta = theta_d); then r = tan(theta).
    """
    k1, k2, k3, k4 = (camera.dist[..., i] for i in range(4))
    rd2 = xd * xd + yd * yd
    on_axis = rd2 < 1e-12
    rd = jnp.sqrt(jnp.where(on_axis, 1.0, rd2))  # = theta_d
    th = rd
    for _ in range(8):
        th2 = th * th
        poly = 1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4)))
        dpoly = 1.0 + th2 * (
            3.0 * k1 + th2 * (5.0 * k2 + th2 * (7.0 * k3 + th2 * 9.0 * k4))
        )
        th = th - (th * poly - rd) / jnp.maximum(dpoly, 1e-6)
    th = jnp.clip(th, 0.0, 0.5 * jnp.pi - 1e-3)
    scale = jnp.where(on_axis, 1.0, jnp.tan(th) / rd)
    return xd * scale, yd * scale


def _surfel_alphas(px, py, d, valid, camera, config, with_depth=False):
    """Alphas of K surfels at P pixels. px/py: (P,), d: (K, 12) rows.

    With ``with_depth`` also returns (P, K, 2) per-pixel values
    [z, z^2] of the ray/disk INTERSECTION depth (the paper's depth, not the
    splat center's) — falling back to the center depth on pixels where the
    low-pass filter dominates (edge-on: the intersection is ill-defined).

    Camera models (camera.camera_model, static):
      - "pinhole": ray through the origin with direction (xn, yn, 1).
      - "fisheye": same perspective system with (xn, yn) recovered by
        inverting the exact equidistant lens per pixel
        (_invert_equidistant) — the ray set is still t (xn, yn, 1).
      - "ortho": parallel rays, origin (xn, yn, 0), direction (0, 0, 1);
        the 2x2 system loses its z-coupling terms.
    """
    qc, a, b = d[:, 0:3], d[:, 3:6], d[:, 6:9]
    c2, op = d[:, 9:11], d[:, 11]
    xn = (px[:, None] - camera.cx) / camera.fx  # (P, 1) broadcast vs (K,)
    yn = (py[:, None] - camera.cy) / camera.fy
    if camera.camera_model == "fisheye":
        xn, yn = _invert_equidistant(camera, xn, yn)

    if camera.camera_model == "ortho":
        A11 = jnp.broadcast_to(a[None, :, 0], (px.shape[0], a.shape[0]))
        A12 = jnp.broadcast_to(b[None, :, 0], A11.shape)
        A21 = jnp.broadcast_to(a[None, :, 1], A11.shape)
        A22 = jnp.broadcast_to(b[None, :, 1], A11.shape)
        r1 = xn - qc[None, :, 0]
        r2 = yn - qc[None, :, 1]
    else:
        A11 = a[None, :, 0] - xn * a[None, :, 2]  # (P, K)
        A12 = b[None, :, 0] - xn * b[None, :, 2]
        A21 = a[None, :, 1] - yn * a[None, :, 2]
        A22 = b[None, :, 1] - yn * b[None, :, 2]
        r1 = xn * qc[None, :, 2] - qc[None, :, 0]
        r2 = yn * qc[None, :, 2] - qc[None, :, 1]

    det = A11 * A22 - A12 * A21
    ok = jnp.abs(det) > 1e-9  # ray not parallel to the disk plane
    det_safe = jnp.where(ok, det, 1.0)  # double-where: no NaN grads
    u = (r1 * A22 - r2 * A12) / det_safe
    v = (A11 * r2 - A21 * r1) / det_safe
    s2 = jnp.minimum(u * u + v * v, 1e4)
    g_surf = jnp.where(ok, jnp.exp(-0.5 * s2), 0.0)

    dx = px[:, None] - c2[None, :, 0]
    dy = py[:, None] - c2[None, :, 1]
    g_filt = jnp.exp(-(dx * dx + dy * dy) / (2.0 * _FILTER_SIGMA2))
    g = jnp.maximum(g_surf, g_filt)  # the paper's low-pass max

    alpha = jnp.minimum(op[None, :] * g, config.max_alpha)
    keep = valid[None, :] & (alpha >= config.alpha_threshold)
    alpha = jnp.where(keep, alpha, 0.0)
    if not with_depth:
        return alpha
    z_surf = (
        qc[None, :, 2] + u * a[None, :, 2] + v * b[None, :, 2]
    )
    use_surf = ok & (g_surf >= g_filt)
    z = jnp.where(use_surf, z_surf, qc[None, :, 2])
    vals = jnp.stack([z, z * z], axis=-1)  # (P, K, 2)
    return alpha, vals


def render_surfels(
    means3d: jax.Array,
    scales: jax.Array,  # (N, 2) or (N, 3) log scales
    quats: jax.Array,
    opacities: jax.Array,
    features: jax.Array,  # (N, 3) RGB or (N, K, 3) SH
    camera: Camera,
    sh_degree: int | None = None,
    background_color: jax.Array | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    return_aux: bool = False,
    return_depth: bool = False,
    return_normals: bool = False,
    return_distortion: bool = False,
    viewport_rows=None,
):
    """Render 2D gaussian surfels to an (H, W, 3) image.

    ``viewport_rows=(row0, height)`` renders only image rows
    [row0, row0+height) — the same tile-row slab primitive as
    render_gaussians, so surfel scenes shard over the ('data','tile') mesh
    too. The alpha math keeps using ABSOLUTE pixel coordinates (only
    binning/rasterization shift into slab space).

    Same surface as render_gaussians; extra outputs (appended in this order,
    aux last):
      - ``return_depth``: accumulated per-pixel ray/disk INTERSECTION depth
        (the paper's depth; premultiplied — divide by
        ``1 - final_transmittance`` for expected depth).
      - ``return_normals``: accumulated camera-frame surfel normals
        (premultiplied).
      - ``return_distortion``: the 2DGS depth-distortion map
        2 * (alpha * sum(w z^2) - sum(w z)^2) — the pairwise-depth-spread
        regularizer of the paper's eq. 4 in moment form; take its mean over
        covered pixels as the loss.
    """
    if config.raster_impl != "xla":
        raise ValueError(
            f"surfels render through the XLA route only, got raster_impl="
            f"{config.raster_impl!r}"
        )
    N = means3d.shape[0]

    def eval_colors(features_, means3d_, camera_):
        if sh_degree is None:
            return features_
        return sh_to_color(features_, means3d_, camera_.position, sh_degree)

    if background_color is None:
        background = jnp.zeros((3,), features.dtype)
    else:
        background = jnp.asarray(background_color, dtype=features.dtype)

    # Flattened-gaussian bound for culling/AABB/binning: the disk is the
    # support of a 3D gaussian with a ~zero third axis, so the 3DGS
    # projection bounds it.
    scales3 = jnp.concatenate(
        [scales[:, :2], jnp.full((N, 1), _TINY_LOG_SCALE, scales.dtype)],
        axis=-1,
    )
    proj = project_gaussians(means3d, scales3, quats, opacities, camera,
                             config)
    # The EWA bound alone does NOT cover the low-pass filter: along an
    # edge-on disk's thin axis it gives ~3.33*sqrt(eps2d) ~ 1.8 px, while
    # g_filt stays above alpha_threshold out to
    # sqrt(2 sigma_f^2 ln(op/thresh)) ~ 2.3 px — the filter-kept footprint
    # would be truncated at tile borders. Widen surviving radii to the
    # filter's own support.
    safe_op = jnp.maximum(opacities, config.alpha_threshold)
    filter_r = jnp.ceil(jnp.sqrt(
        2.0 * _FILTER_SIGMA2 * jnp.log(safe_op / config.alpha_threshold)
    )).astype(proj.radii.dtype)
    radii = jnp.where(
        proj.radii > 0, jnp.maximum(proj.radii, filter_r[:, None]),
        proj.radii,
    )
    proj = proj._replace(radii=radii)
    if viewport_rows is None:
        row0, out_h = 0, camera.H
        means2d_slab = proj.means2d
    else:
        row0, out_h = viewport_rows
        if out_h % config.tile_size != 0:
            raise ValueError(
                f"viewport height {out_h} must be a multiple of tile_size "
                f"{config.tile_size}"
            )
        shift = jnp.stack(
            [jnp.zeros((), proj.means2d.dtype),
             jnp.asarray(row0, proj.means2d.dtype)]
        )
        means2d_slab = proj.means2d - shift[None, :]
    binning = bin_gaussians_to_tiles(
        means2d_slab, proj.radii, proj.depths, out_h, camera.W, config
    )

    want_vals = return_depth or return_distortion
    want_maps = return_depth or return_normals or return_distortion

    def oriented_normals(data):
        # (N, 3) form of oriented_normal_columns for the XLA-oracle path.
        cols = tuple(data[:, i] for i in range(12))
        return jnp.stack(oriented_normal_columns(cols), axis=-1)

    colors = eval_colors(features, means3d, camera)
    data = surfel_alpha_data(means3d, scales, quats, opacities, camera)
    channels = [colors]
    if return_normals:
        channels.append(oriented_normals(data).astype(colors.dtype))
    colors_ext = jnp.concatenate(channels, axis=-1)
    background_ext = jnp.concatenate(
        [background,
         jnp.zeros((colors_ext.shape[-1] - 3,), background.dtype)]
    )

    def alpha_fn(px_t, py_t, safe, valid):
        # py arrives in slab coordinates; the surfel response is defined in
        # absolute pixel coordinates.
        return _surfel_alphas(
            px_t, py_t + jnp.asarray(row0, py_t.dtype), data[safe], valid,
            camera, config, with_depth=want_vals,
        )

    img, raster_aux = rasterize_xla_generic(
        alpha_fn, N, colors_ext, background_ext, binning,
        out_h, camera.W, config,
        n_pixel_values=2 if want_vals else 0,
    )
    # Channel layout: [rgb(3), normals(3 if requested), m1, m2] where
    # m1 = sum(w z), m2 = sum(w z^2) (present when want_vals).
    nc = 6 if return_normals else 3
    m1 = img[..., nc] if want_vals else None
    m2 = img[..., nc + 1] if want_vals else None

    ordered = [img[..., :3]]
    if return_depth:
        ordered.append(m1)
    if return_normals:
        ordered.append(img[..., 3:6])
    if return_distortion:
        alpha_map = 1.0 - raster_aux.final_transmittance
        ordered.append(2.0 * (alpha_map * m2 - m1 * m1))
    if return_aux:
        ordered.append(RenderAux(binning=binning.aux, raster=raster_aux))
    return ordered[0] if len(ordered) == 1 else tuple(ordered)


def backproject_normals_from_depth(
    expected_depth: jax.Array,  # (H, W) expected depth (depth / alpha)
    camera: Camera,
    row0=0,
    ghost_rows=None,
) -> jax.Array:
    """(H, W, 3) camera-frame normals from the depth map's local geometry.

    Backprojects each pixel to a camera-frame point p = z * (xn, yn, 1) and
    takes the normalized cross product of the screen-space finite
    differences dp/dx x dp/dy — the "depth normal" side of the 2DGS paper's
    normal-consistency regularization. Oriented toward the viewer (n_z < 0).

    ``row0``: absolute image row of the map's first row — pass the slab
    offset when the map is a tile-row slab (parallel/sharding.py) so the
    backprojected rays match the full-image geometry. May be traced.

    ``ghost_rows``: optional ((W,), (W,)) expected-depth rows just above /
    below this map — the halo a sharded caller fetched from its 'tile'-axis
    neighbors (train.train_step_sharded_surfel ppermutes them over NVLink (NCCL)), so
    the y finite-difference stencil at slab boundaries sees the true
    neighboring rows and sharded == single-device exactly. When absent (or
    at the global image edges) reflective ghosts g = 2 p0 - p1 are
    synthesized, which makes the centered difference reduce to the
    one-sided edge difference of numpy-style gradient.
    """
    H, W = expected_depth.shape
    d = expected_depth
    top = 2.0 * d[0] - d[1] if ghost_rows is None else ghost_rows[0]
    bot = 2.0 * d[-1] - d[-2] if ghost_rows is None else ghost_rows[1]
    d_pad = jnp.concatenate([top[None, :], d, bot[None, :]], axis=0)
    xs = (jnp.arange(W, dtype=d.dtype) + 0.5 - camera.cx)
    ys = (jnp.arange(-1, H + 1, dtype=d.dtype) + 0.5
          + jnp.asarray(row0, d.dtype) - camera.cy)
    xn = xs[None, :] / camera.fx
    yn = ys[:, None] / camera.fy
    p = jnp.stack([d_pad * xn, d_pad * yn, d_pad], axis=-1)  # (H+2, W, 3)
    dpdx = jnp.gradient(p[1:-1], axis=1)
    dpdy = 0.5 * (p[2:] - p[:-2])  # centered everywhere (ghost-padded)
    n = jnp.cross(dpdx, dpdy)
    n = n / jnp.maximum(jnp.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return jnp.where(n[..., 2:3] > 0, -n, n)


def expected_depth_map(depth, final_transmittance, alpha_floor=0.5):
    """(edepth, covered) with the double-where sanitization of the
    normal-consistency pipeline: uncovered pixels get a dummy depth of 1 so
    no division/normalize NaN is ever created. Exposed separately so the
    sharded trainer can halo-exchange edepth's boundary rows before the
    finite-difference stencil."""
    alpha = 1.0 - final_transmittance
    covered = alpha > alpha_floor
    safe_a = jnp.where(covered, jnp.maximum(alpha, 1e-6), 1.0)
    return jnp.where(covered, depth, 1.0) / safe_a, covered


def normal_consistency_terms(
    depth: jax.Array,  # (H, W) accumulated depth (premultiplied)
    normal: jax.Array,  # (H, W, 3) accumulated normal (premultiplied)
    final_transmittance: jax.Array,  # (H, W)
    camera: Camera,
    alpha_floor: float = 0.5,
    row0=0,
    ghost_rows=None,
) -> tuple[jax.Array, jax.Array]:
    """(numerator, denominator) of the normal-consistency regularizer —
    the separable form for sharded training: each device computes its
    slab's terms (``row0`` = slab offset, ``ghost_rows`` = halo-exchanged
    neighbor edepth rows) and the loss is psum(num) / max(psum(den), 1)."""
    alpha = 1.0 - final_transmittance
    # One shared sanitization (expected_depth_map) so the halo rows the
    # sharded trainer exchanges are computed by the SAME code path as the
    # in-slab values. Double-where: at uncovered pixels the accumulated
    # normal is exactly zero and normalize's backward is 0/0 — replace the
    # INPUTS with a dummy unit vector there so no NaN is ever created (the
    # w = 0 weight cannot cancel a NaN after the fact).
    edepth, covered = expected_depth_map(
        depth, final_transmittance, alpha_floor
    )
    safe_a = jnp.where(covered, jnp.maximum(alpha, 1e-6), 1.0)
    unit_z = jnp.array([0.0, 0.0, -1.0], normal.dtype)
    n_render = jnp.where(
        covered[..., None], normal / safe_a[..., None], unit_z
    )
    n_render = n_render / jnp.maximum(
        jnp.linalg.norm(n_render, axis=-1, keepdims=True), 1e-12
    )
    n_depth = backproject_normals_from_depth(
        edepth, camera, row0=row0, ghost_rows=ghost_rows
    )
    w = jnp.where(covered, alpha, 0.0)
    dots = jnp.sum(n_render * jax.lax.stop_gradient(n_depth), axis=-1)
    return jnp.sum(w * (1.0 - dots)), jnp.sum(w)


def normal_consistency_loss(
    depth: jax.Array,  # (H, W) accumulated depth (premultiplied)
    normal: jax.Array,  # (H, W, 3) accumulated normal (premultiplied)
    final_transmittance: jax.Array,  # (H, W)
    camera: Camera,
    alpha_floor: float = 0.5,
) -> jax.Array:
    """The 2DGS paper's normal-consistency regularizer: alpha-weighted
    (1 - n_render . n_depth), tying each surfel's orientation to the local
    surface implied by the rendered depth. Only pixels with coverage above
    ``alpha_floor`` contribute (background/silhouette pixels have no
    meaningful depth normal).

    Pass the depth map from ``render_surfels(..., return_depth=True)``: it
    blends the per-pixel ray/disk INTERSECTION depth (the paper's depth),
    so a single tilted surfel's interior already traces its tilt and the
    depth-backprojected normals agree with the surfel normals at any splat
    size (validated by test_normal_consistency_tilted_wall)."""
    num, den = normal_consistency_terms(
        depth, normal, final_transmittance, camera, alpha_floor
    )
    return num / jnp.maximum(den, 1.0)
