"""Real spherical-harmonics color evaluation, degrees 0-3 (pure JAX).

The reference leaves SH evaluation unimplemented — render_gaussians prints
"WARN: SH evaluation not implemented yet" and truncates features to RGB
(/root/reference/mojosplat/render.py:82-87). This module closes that gap with
the standard 3DGS / gsplat real-SH basis so that BASELINE config 4 (1M
gaussians, 1080p, SH, fwd+bwd) is renderable and trainable.

Convention matches gsplat's ``spherical_harmonics``: coefficients are laid out
``(N, (degree+1)^2, channels)`` band-major; the caller adds the +0.5 offset and
clamps at 0 (done by ``sh_to_color``). Fully differentiable w.r.t. both the
coefficients and (through the view directions) the gaussian means.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Band constants (standard real SH, as in 3DGS/gsplat CUDA kernels).
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

MAX_SH_DEGREE = 3


def num_sh_bases(degree: int) -> int:
    """(degree+1)^2 coefficients per channel."""
    return (degree + 1) ** 2


def _safe_normalize(x: jax.Array) -> jax.Array:
    """Row-normalize (N, 3) directions, NaN-free at x == 0 under autodiff.

    A zero direction really occurs — dead zero-padded gaussian slots sit AT
    the camera origin — and the backward of norm/normalize at exactly 0 is
    0/0 = NaN (sqrt's derivative is inf at 0, and 0 * inf = NaN even though
    dead slots' upstream cotangent is exactly zero: they are culled to
    radius 0, so their color never touches a pixel). ``rsqrt(n2 + eps)`` is
    smooth at 0 with a finite (<= 1e12) derivative, so that exactly-zero
    upstream cotangent yields an exactly-zero gradient. No selects and no
    custom rules: a jnp.where-based double-guard here (and even a
    custom_jvp with selects in the rule) measurably broke XLA's fusion of
    the SH stage and cost ~40% of the 1M-gaussian headline step.
    """
    n2 = jnp.sum(x * x, axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(n2 + 1e-24)


def eval_sh(
    sh_coeffs: jax.Array,  # (N, K, C) with K >= (degree+1)^2
    dirs: jax.Array,  # (N, 3) view directions (need not be normalized)
    degree: int,
) -> jax.Array:
    """Evaluate SH at unit directions. Returns (N, C) raw band sums."""
    if not 0 <= degree <= MAX_SH_DEGREE:
        raise ValueError(f"SH degree must be in [0, {MAX_SH_DEGREE}], got {degree}")
    needed = num_sh_bases(degree)
    if sh_coeffs.shape[-2] < needed:
        raise ValueError(
            f"degree {degree} needs {needed} SH bases, got {sh_coeffs.shape[-2]}"
        )

    d = _safe_normalize(dirs)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]  # (N,)

    # Evaluate the basis as one (N, K) matrix and contract once. The
    # band-by-band slice-multiply-accumulate form makes reverse-mode AD pad
    # every (N, C) band gradient back to (N, K, C) — ~46 coefficient-sized
    # temporaries (4.4 GB at 500k gaussians, SH3); this form produces one.
    one = jnp.ones_like(x)
    basis = [_C0 * one]
    if degree >= 1:
        basis += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree >= 3:
        basis += [
            _C3[0] * y * (3.0 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3.0 * yy),
        ]
    B = jnp.stack(basis, axis=-1)  # (N, needed)
    # "highest": a float32 contraction may otherwise run in TF32 on the GPU.
    return jnp.einsum(
        "nk,nkc->nc", B, sh_coeffs[..., :len(basis), :], precision="highest"
    )


def rgb_to_sh0(rgb):
    """Inverse of the band-0 rendering convention: coefficients whose
    ``sh_to_color`` at degree 0 reproduces ``rgb`` (color = C0*sh + 0.5)."""
    return (jnp.asarray(rgb) - 0.5) / _C0


def sh_to_color(
    sh_coeffs: jax.Array,  # (N, K, C)
    means3d: jax.Array,  # (N, 3) world-space gaussian centers
    cam_position: jax.Array,  # (3,) camera center in world space
    degree: int,
) -> jax.Array:
    """View-dependent RGB from SH: eval at (mean - cam) directions, +0.5
    offset, clamped at 0 (3DGS rendering convention)."""
    dirs = means3d - cam_position[None, :]
    return jnp.maximum(eval_sh(sh_coeffs, dirs, degree) + 0.5, 0.0)


def mask_sh_bands(features: jax.Array, active_degree: int) -> jax.Array:
    """Zero SH bands above ``active_degree`` (progressive SH warmup: the
    standard 3DGS recipe raises the active degree every 1000 steps so color
    converges before view dependence). Keeps shapes static — the renderer
    always evaluates the full basis; masked bands contribute zero and
    receive zero gradients through the multiply."""
    K = features.shape[-2]
    keep = num_sh_bases(active_degree)
    idx = jnp.arange(K)
    return jnp.where((idx < keep)[:, None], features, 0.0)
