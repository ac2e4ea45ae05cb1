"""Camera model (JAX pytree).

Mirrors the reference ``Camera`` dataclass (/root/reference/mojosplat/utils.py:5-31):
world-to-camera rotation ``R`` (3,3), translation ``T`` (3,), image size ``H, W``,
pinhole intrinsics ``fx, fy, cx, cy`` and ``near=0.1`` / ``far=100.0`` planes.

Differences from the reference:
  - Registered as a JAX pytree so cameras can be jit arguments, vmapped over
    (a batched camera axis replaces the reference's dormant ``C`` dimension,
    kernels/projection.mojo:14), and sharded over a device mesh.
  - ``H``/``W`` are static metadata (they determine output shapes); all other
    fields are traced arrays, so moving/zooming the camera never recompiles.
  - ``view_matrix`` / ``K`` are derived properties instead of mutated state
    (utils.py:21-31 builds them in ``__post_init__``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["R", "T", "fx", "fy", "cx", "cy", "near", "far", "dist",
                 "rs_vel"],
    meta_fields=["H", "W", "camera_model", "shutter"],
)
@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera with world-to-camera extrinsics.

    Leading batch dimensions are allowed on every data field (e.g. ``R`` of
    shape ``(B, 3, 3)``) for batched multi-view rendering.

    ``camera_model`` selects the lens map (static metadata — it changes the
    traced program):
      - ``"pinhole"`` (default): ideal perspective, optionally with OpenCV
        radial/tangential distortion. ``dist`` holds (k1, k2, p1, p2, k3) —
        the model behind the 5 reserved slots in the reference's flattened
        intrinsics vector ([fx, fy, cx, cy, k1..k5], projection.py:444-447,
        which it always fills with zeros).
      - ``"fisheye"``: OpenCV equidistant fisheye (cv::fisheye convention):
        theta_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8) with
        ``dist`` holding (k1, k2, k3, k4, unused).
      - ``"ortho"``: orthographic, u = fx x + cx (no z divide); ``dist`` is
        ignored. Exact in both projection modes.

    Distortion and the fisheye map are applied by the unscented projection
    mode (config.projection_mode="ut" — sigma points go through the exact
    lens map, so no distortion Jacobian is ever needed); fisheye cameras are
    routed to the unscented path automatically. The EWA mode, like the
    reference, ignores pinhole ``dist``.
    """

    R: jax.Array  # (..., 3, 3) world-to-camera rotation
    T: jax.Array  # (..., 3)    world-to-camera translation
    H: int
    W: int
    fx: jax.Array
    fy: jax.Array
    cx: jax.Array
    cy: jax.Array
    near: jax.Array
    far: jax.Array
    dist: jax.Array  # (..., 5); meaning depends on camera_model (see above)
    # Rolling-shutter se(3) velocity [omega (3), upsilon (3)] over one full
    # frame readout; (R, T) is the MID-exposure pose and the pose at image
    # row r is the left perturbation exp([t omega]x) R, exp([t omega]x) T +
    # t upsilon with t = (r + 0.5)/H - 0.5 in [-0.5, 0.5]. Zeros = static
    # camera. Only read when ``shutter == "rolling"``.
    rs_vel: jax.Array = None  # (..., 6)
    camera_model: str = "pinhole"
    # "global" (default) or "rolling" (rows read top-to-bottom across the
    # frame time). Rolling cameras auto-route to the unscented projection
    # (each sigma point solves its own row time by fixed-point iteration
    # through the exact camera map — the 3DGUT formulation; no
    # motion-Jacobian linearization anywhere).
    shutter: str = "global"

    def __post_init__(self):
        # A directly-constructed Camera (not via Camera.create) would keep
        # the None default as a pytree LEAF, giving it a different treedef
        # from created cameras (breaking tree_map/stacking mixes) and
        # crashing rolling-shutter code. Coerce to the zeros Camera.create
        # would have built.
        if self.rs_vel is None:
            dtype = jnp.result_type(self.fx)
            object.__setattr__(
                self, "rs_vel", jnp.zeros(jnp.shape(self.fx) + (6,), dtype)
            )

    @staticmethod
    def create(
        R,
        T,
        H: int,
        W: int,
        fx,
        fy,
        cx,
        cy,
        near=0.1,
        far=100.0,
        dist=None,
        dtype=jnp.float32,
        camera_model: str = "pinhole",
        rs_vel=None,
        shutter: str = "global",
    ) -> "Camera":
        """Build a camera, coercing scalars/arrays to the given dtype.

        ``dist``: optional (..., 5) distortion coefficients — OpenCV
        (k1, k2, p1, p2, k3) for ``camera_model="pinhole"``, equidistant
        (k1, k2, k3, k4, unused) for ``"fisheye"``; defaults to zeros (ideal
        lens), broadcast to the batch shape of ``fx``.
        """
        if camera_model not in ("pinhole", "fisheye", "ortho"):
            raise ValueError(f"Unknown camera_model: {camera_model!r}")
        if shutter not in ("global", "rolling"):
            raise ValueError(f"Unknown shutter: {shutter!r}")
        as_arr = lambda v: jnp.asarray(v, dtype=dtype)
        fx_a = as_arr(fx)
        if dist is None:
            dist_a = jnp.zeros(fx_a.shape + (5,), dtype)
        else:
            dist_a = jnp.broadcast_to(as_arr(dist), fx_a.shape + (5,))
        if rs_vel is None:
            rs_a = jnp.zeros(fx_a.shape + (6,), dtype)
        else:
            rs_a = jnp.broadcast_to(as_arr(rs_vel), fx_a.shape + (6,))
        return Camera(
            R=as_arr(R),
            T=as_arr(T),
            H=int(H),
            W=int(W),
            fx=fx_a,
            fy=as_arr(fy),
            cx=as_arr(cx),
            cy=as_arr(cy),
            near=as_arr(near),
            far=as_arr(far),
            dist=dist_a,
            rs_vel=rs_a,
            camera_model=camera_model,
            shutter=shutter,
        )

    @property
    def view_matrix(self) -> jax.Array:
        """(..., 4, 4) world-to-camera matrix [R | T; 0 0 0 1] (utils.py:21-29)."""
        batch = self.R.shape[:-2]
        eye = jnp.broadcast_to(jnp.eye(4, dtype=self.R.dtype), batch + (4, 4))
        vm = eye.at[..., :3, :3].set(self.R)
        vm = vm.at[..., :3, 3].set(self.T)
        return vm

    @property
    def K(self) -> jax.Array:
        """(..., 3, 3) intrinsics matrix (utils.py:30-31)."""
        fx, fy, cx, cy = jnp.broadcast_arrays(self.fx, self.fy, self.cx, self.cy)
        z = jnp.zeros_like(fx)
        o = jnp.ones_like(fx)
        rows = jnp.stack(
            [
                jnp.stack([fx, z, cx], axis=-1),
                jnp.stack([z, fy, cy], axis=-1),
                jnp.stack([z, z, o], axis=-1),
            ],
            axis=-2,
        )
        return rows

    @property
    def position(self) -> jax.Array:
        """(..., 3) camera center in world coordinates: -R^T @ T."""
        return -jnp.einsum("...ji,...j->...i", self.R, self.T,
                           precision="highest")


def _rodrigues(omega: jax.Array) -> jax.Array:
    """(..., 3) axis-angle -> (..., 3, 3) rotation, exact Rodrigues with a
    Taylor switch at theta ~ 0 so the zero-rotation point is smooth under
    autodiff (sin(t)/t and (1-cos(t))/t^2 are 0/0 there; the double-where
    keeps the unselected branch's backward finite)."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    small = theta2 < 1e-12
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(
        small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe
    )
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    O = jnp.zeros_like(wx)
    K = jnp.stack(
        [O, -wz, wy, wz, O, -wx, -wy, wx, O], axis=-1
    ).reshape(omega.shape[:-1] + (3, 3))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    return (
        eye + a[..., None, None] * K
        + b[..., None, None] * jnp.einsum("...ij,...jk->...ik", K, K,
                                          precision="highest")
    )


def apply_pose_delta(camera: Camera, delta: jax.Array) -> Camera:
    """Perturb world-to-camera extrinsics by a learnable se(3)-style delta.

    ``delta``: (..., 6) = [omega (3, axis-angle), upsilon (3, translation)],
    broadcasting against the camera's batch shape. The update is a left
    perturbation of the world-to-camera map: R' = exp([omega]x) R,
    T' = exp([omega]x) T + upsilon — at delta = 0 the camera is returned
    bit-identically, and gradients through the Taylor-switched exponential
    are exact there. This is the camera-pose-refinement module (gsplat's
    pose-optimization adjustment, which the reference — forward-only —
    cannot express); optimize deltas with train.selective_adam so views
    absent from a batch keep frozen moments.
    """
    omega = delta[..., 0:3]
    ups = delta[..., 3:6]
    dR = _rodrigues(omega)
    R = jnp.einsum("...ij,...jk->...ik", dR, camera.R, precision="highest")
    T = jnp.einsum("...ij,...j->...i", dR, camera.T,
                   precision="highest") + ups
    return dataclasses.replace(camera, R=R, T=T)


def look_at(eye, target, up) -> tuple[jax.Array, jax.Array]:
    """World-to-camera (R, T) for a camera at ``eye`` looking at ``target``.

    gsplat convention: +X right, +Y down, +Z forward into the scene
    (/root/reference/render_sample.py:12-30).
    """
    eye = jnp.asarray(eye, dtype=jnp.float32)
    target = jnp.asarray(target, dtype=jnp.float32)
    up = jnp.asarray(up, dtype=jnp.float32)

    def _normalize(v):
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-12)

    forward = _normalize(target - eye)
    right = _normalize(jnp.cross(forward, up))
    down = jnp.cross(right, forward)
    R = jnp.stack([right, down, forward], axis=0)
    T = -jnp.matmul(R, eye, precision="highest")
    return R, T
