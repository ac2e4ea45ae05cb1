"""Per-view bilateral-grid appearance correction.

The gsplat ecosystem's ``lib_bilagrid`` module ("Bilateral Guided Radiance
Field Processing", Wang et al. SIGGRAPH 2024) — the stronger variant of the
per-view affine exposure compensation in ``train.apply_exposure``: a low-res
3D grid (spatial y, spatial x, guidance = luminance) of 3x4 affine color
transforms, trilinearly interpolated per pixel. Absorbs spatially-varying
photometric nuisance (vignetting, local auto-white-balance, lens shading)
that a single per-view affine cannot, so the scene's SH colors converge to
one consistent radiance. The reference renderer has no appearance module at
all (forward-only, /root/reference/README.md:145).

Formulation: instead of a per-pixel random gather (CUDA's ``grid_sample``),
the interpolation is factored exactly:

  - the two SPATIAL dims are regular, so they are one ``jax.image.resize``
    (bilinear) of each guidance slice to (H, W) — dense vector math;
  - the GUIDANCE dim is a static ``gd``-step loop of hat-weighted
    accumulation (hat weights sum to 1, reproducing trilinear exactly).

Peak memory is one (H, W, 12) slice (~100 MB at 1080p), not the full
(H, W, gd, 12) stack.

At evaluation time render WITHOUT the correction (or with the identity) so
metrics measure the scene, not the per-view nuisance fit — same rule as
``apply_exposure``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Rec.601 luma; the guidance signal of the bilateral grid.
_LUMA = (0.299, 0.587, 0.114)


def identity_bilateral_grid(
    n_views: int, shape: tuple[int, int, int] = (16, 16, 8)
) -> jax.Array:
    """(V, gh, gw, gd, 12) grids of identity affines [I | 0].

    ``shape`` = (gh, gw, gd): spatial rows, spatial cols, guidance bins.
    The 12 channels are the row-major 3x3 matrix followed by the bias.
    """
    gh, gw, gd = shape
    ident = jnp.concatenate(
        [jnp.eye(3).reshape(9), jnp.zeros(3)]
    )  # (12,)
    return jnp.broadcast_to(
        ident, (n_views, gh, gw, gd, 12)
    ).astype(jnp.float32)


def apply_bilateral_grid(image: jax.Array, grid: jax.Array) -> jax.Array:
    """Apply one view's bilateral grid to an (H, W, 3) image.

    ``grid``: (gh, gw, gd, 12). Guidance is the pixel's Rec.601 luma
    clipped to [0, 1]; spatial sampling uses half-pixel-center bilinear
    (the ``jax.image.resize`` convention). Differentiable in both inputs.
    """
    H, W, _ = image.shape
    gh, gw, gd, pc = grid.shape
    if pc != 12:
        raise ValueError(f"grid last dim must be 12 affine params, got {pc}")

    luma = jnp.clip(
        _LUMA[0] * image[..., 0]
        + _LUMA[1] * image[..., 1]
        + _LUMA[2] * image[..., 2],
        0.0,
        1.0,
    )
    pos = luma * (gd - 1)  # (H, W) in [0, gd-1]

    affine = jnp.zeros((H, W, 12), image.dtype)
    for k in range(gd):  # static, gd is small (default 8)
        # Hat weight: 1 at bin k, linear to 0 at k +- 1; sums to 1 over k.
        wk = jnp.maximum(1.0 - jnp.abs(pos - k), 0.0)
        slice_k = jax.image.resize(
            grid[:, :, k, :], (H, W, 12), method="linear"
        )
        affine = affine + wk[..., None] * slice_k

    A = affine[..., :9].reshape(H, W, 3, 3)
    b = affine[..., 9:]
    return jnp.einsum("hwc,hwdc->hwd", image, A, precision="highest") + b


def bilateral_grid_tv(grids: jax.Array) -> jax.Array:
    """Total-variation regularizer over the grid dims (mean squared
    forward difference along gh, gw, gd), averaged over views — keeps the
    per-view correction smooth so it cannot memorize scene detail.
    ``grids``: (V, gh, gw, gd, 12) (or a single (gh, gw, gd, 12))."""
    tv = 0.0
    for axis in (-4, -3, -2):
        d = jnp.diff(grids, axis=axis)
        tv = tv + jnp.mean(d * d)
    return tv
