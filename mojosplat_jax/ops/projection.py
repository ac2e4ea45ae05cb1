"""EWA projection of 3D Gaussians to 2D screen-space conics (pure JAX).

Implements the same math as the reference's three projection backends
(/root/reference/mojosplat/projection.py:51-283 torch backend,
kernels/projection.mojo:13-257 mojo kernel, and the external gsplat
``fully_fused_projection``), fully vectorized over N: where the reference
launches one GPU thread per gaussian (projection.mojo:308-310), XLA compiles
one fused elementwise program over (N,) arrays.

Numerical contract (gsplat parity, see config.py):
  - quaternion (w,x,y,z) normalized then converted to a rotation matrix
    (projection.py:51-69)
  - covariance = (R S)(R S)^T with S = diag(scales); the public API takes
    log-scales and applies exp() (projection.py:317-318)
  - world->cam: mean_c = R_v mean + t; cov_c = R_v cov R_v^T (projection.py:163-196)
  - perspective EWA with the 0.3*tan_fov guard-band clamp (projection.py:143-148)
  - eps2d dilation of cov2d, det clamped to 1e-10, conic = inverse upper
    triangle (projection.py:242-262)
  - opacity-aware radius extend = min(3.33, sqrt(2 ln(opacity/alpha_thresh)))
    (projection.mojo:214-226; gsplat CUDA semantics) or the torch backend's
    plain 3.33 (projection.py:266-267) when config.opacity_aware_radius=False
  - culling: det>0, near<depth<far (projection.py:271), opacity>=1/255
    (projection.mojo:74-87), radius<=radius_clip, viewport overlap test
    (projection.py:274-280) — all expressed as masks that zero the radii, so
    shapes stay static and the whole stage is differentiable.

Differentiability (the capability the reference lacks entirely — render.py:11
is @torch.no_grad()): every output except the integer radii carries gradients;
culling masks are applied with jnp.where on forward values only.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..camera import Camera
from ..config import DEFAULT_CONFIG, RenderConfig


class ProjectionResult(NamedTuple):
    """Outputs of the projection stage (projection.py:33-38).

    means2d: (N, 2) pixel-space centers.
    conics:  (N, 3) inverse 2D covariance upper triangle [a, b, c].
    depths:  (N,)   camera-space z of each center.
    radii:   (N, 2) integer conservative pixel radii (0 => culled).
    """

    means2d: jax.Array
    conics: jax.Array
    depths: jax.Array
    radii: jax.Array
    # Antialiasing opacity compensation sqrt(det(cov2d)/det(cov2d+eps2d*I))
    # (gsplat's calc_compensations output; 1.0-filled in classic mode).
    # Appended last so positional access to the reference's four outputs
    # (projection.py:33-38) stays valid.
    compensations: jax.Array = None


def quat_to_rotmat(quats: jax.Array) -> jax.Array:
    """(..., 4) wxyz quaternions -> (..., 3, 3) rotation matrices.

    Matches _quat_to_rotmat (projection.py:51-69) including the normalize-first
    convention (F.normalize with eps=1e-12).
    """
    norm = jnp.linalg.norm(quats, axis=-1, keepdims=True)
    q = quats / jnp.maximum(norm, 1e-12)
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    R = jnp.stack(
        [
            1 - 2 * (y**2 + z**2),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x**2 + z**2),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x**2 + y**2),
        ],
        axis=-1,
    )
    return R.reshape(quats.shape[:-1] + (3, 3))


def quat_scale_to_covar(quats: jax.Array, scales: jax.Array) -> jax.Array:
    """3D covariance Sigma = (R S)(R S)^T from wxyz quats and *linear* scales.

    Matches _quat_scale_to_covar_preci with compute_covar=True
    (projection.py:83-87).
    """
    R = quat_to_rotmat(quats)  # (..., 3, 3)
    M = R * scales[..., None, :]  # R @ diag(s)
    return jnp.einsum("...ij,...kj->...ik", M, M, precision="highest")


def world_to_cam(
    means: jax.Array,  # (N, 3)
    covars: jax.Array,  # (N, 3, 3)
    viewmat: jax.Array,  # (4, 4)
) -> tuple[jax.Array, jax.Array]:
    """Transform gaussian means/covariances into camera space
    (projection.py:163-196, single-camera specialization)."""
    R = viewmat[:3, :3]
    t = viewmat[:3, 3]
    means_c = jnp.einsum("ij,nj->ni", R, means, precision="highest") + t
    covars_c = jnp.einsum("ij,njk,lk->nil", R, covars, R, precision="highest")
    return means_c, covars_c


def persp_proj(
    means_c: jax.Array,  # (N, 3) camera-space means
    covars_c: jax.Array,  # (N, 3, 3) camera-space covariances
    fx,
    fy,
    cx,
    cy,
    width: int,
    height: int,
    near=0.1,
) -> tuple[jax.Array, jax.Array]:
    """Perspective EWA projection (projection.py:105-160).

    Returns (means2d (N,2), cov2d (N,2,2)).
    """
    tx, ty, tz = means_c[:, 0], means_c[:, 1], means_c[:, 2]
    # Dummy z = 1 for at/behind-camera gaussians (culled by the near-plane
    # mask downstream): a tiny-epsilon guard would leave 1/z^2 ~ 1e16
    # factors that overflow the f32 conic math to inf and NaN the backward
    # of whole-array reductions (see _fused_cov2d).
    tz_safe = jnp.where(tz > jnp.minimum(1e-3, near), tz, 1.0)
    tz2 = tz_safe * tz_safe

    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy
    tx_c = tz_safe * jnp.clip(tx / tz_safe, -lim_x_neg, lim_x_pos)
    ty_c = tz_safe * jnp.clip(ty / tz_safe, -lim_y_neg, lim_y_pos)

    O = jnp.zeros_like(tz)
    J = jnp.stack(
        [fx / tz_safe, O, -fx * tx_c / tz2, O, fy / tz_safe, -fy * ty_c / tz2],
        axis=-1,
    ).reshape(-1, 2, 3)

    cov2d = jnp.einsum("nij,njk,nlk->nil", J, covars_c, J, precision="highest")
    means2d = jnp.stack(
        [fx * tx / tz_safe + cx, fy * ty / tz_safe + cy], axis=-1
    )
    return means2d, cov2d


def _fused_cov2d(means3d, scales, quats, camera):
    """Fully element-wise EWA projection: quat -> Sigma -> camera frame ->
    2D covariance, with no (N, 3, 3) intermediates.

    Same math as quat_scale_to_covar / world_to_cam / persp_proj (and the
    reference's per-thread scalar pipeline, projection.mojo:90-203), expanded
    component-wise so XLA fuses the whole stage into one pass over N — the
    einsum forms lower to batched 3x3 matmuls that do not fuse.

    Returns (means2d (N,2), depths (N,), c00, c01, c11) with the 2D
    covariance entries NOT yet eps2d-dilated.
    """
    norm = jnp.linalg.norm(quats, axis=-1, keepdims=True)
    q = quats / jnp.maximum(norm, 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    s0, s1, s2 = (jnp.exp(scales[:, i]) for i in range(3))

    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)

    # Sigma = (R S)(R S)^T, unique entries only.
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    s_00 = m00 * m00 + m01 * m01 + m02 * m02
    s_01 = m00 * m10 + m01 * m11 + m02 * m12
    s_02 = m00 * m20 + m01 * m21 + m02 * m22
    s_11 = m10 * m10 + m11 * m11 + m12 * m12
    s_12 = m10 * m20 + m11 * m21 + m12 * m22
    s_22 = m20 * m20 + m21 * m21 + m22 * m22

    V = camera.view_matrix  # (4, 4) traced
    v = [[V[i, j] for j in range(3)] for i in range(3)]
    tvec = [V[i, 3] for i in range(3)]

    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    cam_mean = [
        v[i][0] * mx + v[i][1] * my + v[i][2] * mz + tvec[i] for i in range(3)
    ]
    tx, ty, tz = cam_mean

    # Sigma_c = V Sigma V^T via t_i = Sigma @ v_i (Sigma symmetric).
    def sig_v(a):
        return (
            s_00 * a[0] + s_01 * a[1] + s_02 * a[2],
            s_01 * a[0] + s_11 * a[1] + s_12 * a[2],
            s_02 * a[0] + s_12 * a[1] + s_22 * a[2],
        )

    t0 = sig_v(v[0])
    t1 = sig_v(v[1])
    t2 = sig_v(v[2])

    def dot_v(t, a):
        return t[0] * a[0] + t[1] * a[1] + t[2] * a[2]

    sc00 = dot_v(t0, v[0])
    sc01 = dot_v(t0, v[1])
    sc02 = dot_v(t0, v[2])
    sc11 = dot_v(t1, v[1])
    sc12 = dot_v(t1, v[2])
    sc22 = dot_v(t2, v[2])

    fx, fy, cx, cy = camera.fx, camera.fy, camera.cx, camera.cy
    width, height = camera.W, camera.H

    if camera.camera_model == "ortho":
        # Orthographic projection is linear, so "EWA" is exact here:
        # J = [[fx, 0, 0], [0, fy, 0]] (gsplat's ortho camera model).
        c00 = fx * fx * sc00
        c01 = fx * fy * sc01
        c11 = fy * fy * sc11
        means2d = jnp.stack([fx * tx + cx, fy * ty + cy], axis=-1)
        return means2d, tz, c00, c01, c11

    # Input sanitization (double-where): lanes at/behind the camera plane
    # are culled downstream by the near-plane mask (which reads the REAL
    # tz returned below), but with only a 1e-8 division guard their
    # 1/z^2 ~ 1e16 factor overflows the f32 conic products to inf, and the
    # inf poisons every backward reduction that sums over all gaussians
    # (camera-pose gradients most visibly: dead zero-padded slots sit at
    # the origin, z = 0 exactly). Give those lanes a dummy z = 1 so every
    # intermediate stays finite; 1e-3 matches the unscented path's floor,
    # lowered to camera.near when the user sets a nearer plane so every
    # non-culled gaussian still projects with its real depth.
    z_floor = jnp.minimum(jnp.asarray(1e-3, tz.dtype), camera.near)
    tz_safe = jnp.where(tz > z_floor, tz, 1.0)
    rz = 1.0 / tz_safe
    rz2 = rz * rz

    # Frustum guard-band clamp (projection.py:143-148).
    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x_pos = (width - cx) / fx + 0.3 * tan_fovx
    lim_x_neg = cx / fx + 0.3 * tan_fovx
    lim_y_pos = (height - cy) / fy + 0.3 * tan_fovy
    lim_y_neg = cy / fy + 0.3 * tan_fovy
    txc = tz_safe * jnp.clip(tx * rz, -lim_x_neg, lim_x_pos)
    tyc = tz_safe * jnp.clip(ty * rz, -lim_y_neg, lim_y_pos)

    # cov2d = J Sigma_c J^T with J = [[fx/z, 0, -fx tx/z^2],
    #                                 [0, fy/z, -fy ty/z^2]].
    ax = txc * rz  # tx/z (clamped)
    ay = tyc * rz
    c00 = fx * fx * rz2 * (s2c(sc00, sc02, sc22, ax))
    c11 = fy * fy * rz2 * (s2c(sc11, sc12, sc22, ay))
    c01 = fx * fy * rz2 * (sc01 - ay * sc02 - ax * sc12 + ax * ay * sc22)

    means2d = jnp.stack([fx * tx * rz + cx, fy * ty * rz + cy], axis=-1)
    return means2d, tz, c00, c01, c11


def s2c(saa, sab, sbb, a):
    """Quadratic form (1, -a) [[saa, sab], [sab, sbb]] (1, -a)^T."""
    return saa - 2.0 * a * sab + a * a * sbb


def apply_lens(camera, xn, yn):
    """Lens map: (undistorted normalized coords) -> (distorted normalized
    coords), per camera.camera_model. Used by the unscented projection path,
    which pushes sigma points through the EXACT lens map — the point of the
    3DGUT formulation: no distortion Jacobian is ever needed.

    "pinhole": OpenCV radial/tangential distortion (k1, k2, p1, p2, k3) —
    the model behind the reference's 5 reserved-and-zeroed intrinsics slots
    (projection.py:444-447). Zero coefficients reduce to the ideal pinhole
    bit-for-bit (factor == 1, tangential terms == 0).

    "fisheye": OpenCV equidistant fisheye (cv::fisheye):
    r = |(xn, yn)|, theta = atan(r),
    theta_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8),
    out = (theta_d / r) (xn, yn), with dist = (k1, k2, k3, k4, unused).
    atan saturates for wide angles, so FOVs approaching 180 deg stay finite
    where the pinhole map diverges.
    """
    if camera.camera_model == "fisheye":
        k1, k2, k3, k4 = (camera.dist[..., i] for i in range(4))
        r2 = xn * xn + yn * yn
        # Double-where: sqrt/atan-over-r has a 0/0 removable singularity on
        # the optical axis; sanitize the INPUT so the backward of the
        # unselected branch stays finite (the lens map is even in r there,
        # so the true on-axis derivative of the scale factor is 0).
        on_axis = r2 < 1e-12
        r = jnp.sqrt(jnp.where(on_axis, 1.0, r2))
        th = jnp.arctan(r)
        th2 = th * th
        th_d = th * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
        scale = jnp.where(on_axis, 1.0, th_d / r)
        return xn * scale, yn * scale
    k1, k2, p1, p2, k3 = (camera.dist[..., i] for i in range(5))
    r2 = xn * xn + yn * yn
    factor = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xn * factor + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * factor + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return xd, yd


def _unscented_cov2d(means3d, scales, quats, camera, config):
    """3DGUT-style unscented-transform projection (config.projection_mode
    "ut"): the reference README's "Unscented Projection" wishlist item.

    Instead of linearizing the pinhole map with the EWA Jacobian
    (projection.py:105-160), the 2d+1 = 7 sigma points of each 3D gaussian
    (center plus/minus the scaled columns of the covariance factor
    M = R_view R S, an exact matrix square root of the camera-frame
    covariance) are pushed through the *exact* projection and the 2D
    mean/covariance recovered as their weighted moments — higher-order
    accurate for large/near splats where the Jacobian underestimates
    curvature. Standard UT weights: lambda = alpha^2 (d+kappa) - d,
    w0_m = lambda/(d+lambda), w0_c = w0_m + 1 - alpha^2 + beta,
    wi = 1/(2(d+lambda)).

    Returns the same (means2d, depths, c00, c01, c11) contract as
    _fused_cov2d (pre-eps2d covariance) so culling/conic/radius logic is
    shared between modes. Uses small batched (N,3,3) einsums rather than the
    EWA path's fully-scalarized form — this is the alternate mode, not the
    headline path.
    """
    d = 3.0
    lam = config.ut_alpha**2 * (d + config.ut_kappa) - d
    gamma = jnp.sqrt(d + lam)

    R = quat_to_rotmat(quats)  # (N, 3, 3)
    M = R * jnp.exp(scales)[:, None, :]  # R @ diag(s)
    mu_c = jnp.matmul(means3d, camera.R.T, precision="highest") + camera.T
    Mc = jnp.einsum("ij,njk->nik", camera.R, M, precision="highest")

    cols = gamma * Mc.transpose(0, 2, 1)  # (N, 3, 3) rows = scaled columns

    # Input sanitization (double-where): behind-camera gaussians are culled
    # downstream (depth <= near zeroes their radii), but their sigma points
    # would still flow garbage magnitudes (x / z_floor ~ 1e8, squared past
    # f32 range in the conic backward) through autodiff as NaN. Replace the
    # *inputs* for those lanes with a unit dummy so every branch value stays
    # finite; straddling splats (center in front, some sigma point behind)
    # get a z floor relative to their center depth, which bounds the pushed
    # points to ~100x the focal scale — the UT analogue of EWA's guard-band
    # clamp (projection.py:143-148).
    zc = mu_c[:, 2]
    ok = zc > 1e-3
    mu_safe = jnp.where(ok[:, None], mu_c, jnp.array([0.0, 0.0, 1.0]))
    cols_safe = jnp.where(ok[:, None, None], cols, 0.0)
    pts = jnp.concatenate(
        [
            mu_safe[:, None, :],
            mu_safe[:, None, :] + cols_safe,
            mu_safe[:, None, :] - cols_safe,
        ],
        axis=1,
    )  # (N, 7, 3)

    def to_pixels(p):
        """(..., 3) camera-frame points -> ((..., 2) pixels, depth z)."""
        if camera.camera_model == "ortho":
            # Orthographic: no z-divide and no lens; the UT then recovers
            # the exact linear pushforward (all points map affinely).
            xd, yd = p[..., 0], p[..., 1]
        else:
            z_floor = 0.01 * jnp.where(ok, zc, 1.0)
            z = jnp.maximum(p[..., 2], z_floor[:, None])
            xn = p[..., 0] / z  # (..., 7) normalized image coordinates
            yn = p[..., 1] / z
            xd, yd = apply_lens(camera, xn, yn)
        return jnp.stack(
            [camera.fx * xd + camera.cx, camera.fy * yd + camera.cy],
            axis=-1,
        )

    if camera.shutter == "rolling":
        # Rolling shutter (3DGUT formulation): (R, T) is the MID-exposure
        # pose; the pose at normalized row time t in [-0.5, 0.5] is the
        # left se(3) perturbation exp([t omega]x) applied to the base map,
        # so a base-camera-frame point q lands at exp([t omega]x) q +
        # t upsilon — the world->base transform above is reused as-is.
        # Each sigma point solves its own row time by fixed-point
        # iteration through the EXACT camera map (no motion Jacobian),
        # which converges in 2-3 iterations for sub-frame motion.
        om = camera.rs_vel[..., 0:3]
        up = camera.rs_vel[..., 3:6]
        t = jnp.zeros(pts.shape[:-1], pts.dtype)  # (N, 7) row times

        def rotate(v, t):
            # Rodrigues in vector form with theta^2-Taylor switches:
            # smooth at omega = 0 and at t = 0 (no |omega| cusp).
            w = t[..., None] * om  # (N, 7, 3)
            th2 = jnp.sum(w * w, axis=-1)
            small = th2 < 1e-12
            th2_safe = jnp.where(small, 1.0, th2)
            th = jnp.sqrt(th2_safe)
            c = jnp.cos(jnp.where(small, 0.0, th))
            a = jnp.where(small, 1.0 - th2 / 6.0, jnp.sin(th) / th)
            b = jnp.where(small, 0.5 - th2 / 24.0, (1.0 - c) / th2_safe)
            cross = jnp.cross(w, v)
            dot = jnp.sum(w * v, axis=-1, keepdims=True)
            cos_full = jnp.where(small, 1.0 - th2 / 2.0, c)
            return (
                v * cos_full[..., None]
                + cross * a[..., None]
                + w * (dot * b[..., None])
            )

        p_t = pts
        for _ in range(config.rs_iterations):
            p_t = rotate(pts, t) + t[..., None] * up
            v_pix = to_pixels(p_t)[..., 1]
            t = jnp.clip(v_pix / camera.H, 0.0, 1.0) - 0.5
        p_t = rotate(pts, t) + t[..., None] * up
        y = to_pixels(p_t)  # (N, 7, 2)
        # Depth at the center point's own row time (true camera z there).
        zc = jnp.where(ok, p_t[:, 0, 2], zc)
    else:
        y = to_pixels(pts)  # (N, 7, 2)

    w0_m = lam / (d + lam)
    wi = 1.0 / (2.0 * (d + lam))
    w0_c = w0_m + 1.0 - config.ut_alpha**2 + config.ut_beta
    wm = jnp.concatenate([jnp.array([w0_m]), jnp.full((6,), wi)])
    wc = jnp.concatenate([jnp.array([w0_c]), jnp.full((6,), wi)])

    hi = "highest"  # keep float32 contractions out of TF32
    mean = jnp.einsum("k,nkc->nc", wm, y, precision=hi)
    diff = y - mean[:, None, :]
    c00 = jnp.einsum("k,nk->n", wc, diff[..., 0] * diff[..., 0], precision=hi)
    c01 = jnp.einsum("k,nk->n", wc, diff[..., 0] * diff[..., 1], precision=hi)
    c11 = jnp.einsum("k,nk->n", wc, diff[..., 1] * diff[..., 1], precision=hi)
    # Real depth (zc, not the sanitized dummy) so near/far culling sees the
    # true camera-space z and removes the dummy-projected lanes.
    return mean, zc, c00, c01, c11


def project_gaussians(
    means3d: jax.Array,  # (N, 3) world-space centers
    scales: jax.Array,  # (N, 3) log-space scales
    quats: jax.Array,  # (N, 4) wxyz quaternions
    opacities: jax.Array,  # (N,) post-activation opacities
    camera: Camera,
    config: RenderConfig = DEFAULT_CONFIG,
) -> ProjectionResult:
    """Project 3D gaussians to screen space with culling.

    Same public signature role as project_gaussians (projection.py:15-48), with
    the backend dispatch replaced by a single implementation.

    Fisheye cameras are routed to the unscented path regardless of
    config.projection_mode: EWA's linearization (and its guard-band clamp)
    is specific to the perspective map, while the sigma points go through
    the exact equidistant lens (apply_lens). Rolling-shutter cameras route
    the same way — each sigma point carries its own row-time pose, which
    has no EWA-Jacobian analogue.
    """
    if (config.projection_mode == "ut" or camera.camera_model == "fisheye"
            or camera.shutter == "rolling"):
        means2d, depths, c00_raw, c01_raw, c11_raw = _unscented_cov2d(
            means3d, scales, quats, camera, config
        )
    elif config.projection_mode == "ewa":
        means2d, depths, c00_raw, c01_raw, c11_raw = _fused_cov2d(
            means3d, scales, quats, camera
        )
    else:
        raise ValueError(
            f"Unknown projection_mode: {config.projection_mode!r}"
        )

    # eps2d dilation (projection.py:242) and determinant clamp (:248).
    c00 = c00_raw + config.eps2d
    c11 = c11_raw + config.eps2d
    c01 = c01_raw
    det = jnp.maximum(c00 * c11 - c01 * c01, 1e-10)

    conics = jnp.stack([c11 / det, -c01 / det, c00 / det], axis=-1)

    # Antialiasing compensation (gsplat calc_compensations semantics): the
    # ratio of the pre-/post-dilation densities' normalizers. 1.0 when the
    # raw covariance dominates eps2d (big splats), -> 0 for sub-pixel splats
    # whose screen-space energy the dilation would otherwise inflate.
    if config.antialiased:
        det_raw = c00_raw * c11_raw - c01_raw * c01_raw
        # Double-where: sqrt's backward is inf at 0, and degenerate splats
        # (rank-1 covariances, or behind-camera lanes the UT mode maps to a
        # zero dummy) hit det_raw <= 0 exactly — the NaN would escape
        # through the pose/intrinsics gradient path even though the splat
        # itself is culled.
        pos = det_raw > 0.0
        det_raw_safe = jnp.where(pos, det_raw, 1.0)
        compensations = jnp.where(pos, jnp.sqrt(det_raw_safe / det), 0.0)
    else:
        compensations = jnp.ones_like(det)

    # Radius: opacity-aware (projection.mojo:214-226 / gsplat CUDA) or the
    # plain 3.33-sigma variant (projection.py:266-267).
    if config.opacity_aware_radius:
        safe_op = jnp.maximum(opacities, config.alpha_threshold)
        extend = jnp.minimum(
            config.radius_extend,
            jnp.sqrt(2.0 * jnp.log(safe_op / config.alpha_threshold)),
        )
    else:
        extend = config.radius_extend
    radius_x = jnp.ceil(extend * jnp.sqrt(jnp.maximum(c00, 0.0)))
    radius_y = jnp.ceil(extend * jnp.sqrt(jnp.maximum(c11, 0.0)))

    # Culling masks (projection.py:271-280 + projection.mojo:74-87,228-244).
    valid = (det > 0) & (depths > camera.near) & (depths < camera.far)
    if config.opacity_aware_radius:
        valid &= opacities >= config.alpha_threshold
    valid &= ~(
        (radius_x <= config.radius_clip) & (radius_y <= config.radius_clip)
    )
    inside = (
        (means2d[:, 0] + radius_x > 0)
        & (means2d[:, 0] - radius_x < camera.W)
        & (means2d[:, 1] + radius_y > 0)
        & (means2d[:, 1] - radius_y < camera.H)
    )
    keep = valid & inside

    radius = jnp.stack([radius_x, radius_y], axis=-1)
    radius = jnp.where(keep[:, None], radius, 0.0)
    radii = jax.lax.stop_gradient(radius).astype(jnp.int32)

    return ProjectionResult(
        means2d=means2d,
        conics=conics,
        depths=depths,
        radii=radii,
        compensations=compensations,
    )
