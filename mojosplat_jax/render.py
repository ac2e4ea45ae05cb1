"""End-to-end render orchestrator: projection -> binning -> SH -> rasterization.

Mirrors render_gaussians (/root/reference/mojosplat/render.py:12-103) minus the
reference's limitations: this pipeline is jittable end-to-end, differentiable
(the reference is @torch.no_grad(), render.py:11), evaluates SH colors (the
reference only warns, render.py:82-87), and never branches on data (the
reference early-returns a black image on zero intersections, render.py:73-76 —
here an empty intersection list naturally produces the background image through
the same traced program).

``features`` is either (N, 3) RGB (sh_degree=None) or (N, K, 3) SH coefficients
(sh_degree given), matching the reference's dual-use ``features`` argument
(render.py:17,82-87).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .camera import Camera
from .config import DEFAULT_CONFIG, RenderConfig
from .ops.binning import BinningAux, bin_gaussians_to_tiles
from .ops.projection import project_gaussians
from .ops.rasterization import RasterAux, rasterize_gaussians
from .ops.sh import sh_to_color


class RenderAux(NamedTuple):
    """Observability bundle: counters a production renderer must surface
    (SURVEY.md section 5, metrics/logging row)."""

    binning: BinningAux
    raster: RasterAux


def render_gaussians(
    means3d: jax.Array,  # (N, 3) world coordinates
    scales: jax.Array,  # (N, 3) log-space scales
    quats: jax.Array,  # (N, 4) wxyz quaternions
    opacities: jax.Array,  # (N,) post-activation opacities
    features: jax.Array,  # (N, 3) RGB or (N, K, 3) SH coefficients
    camera: Camera,
    sh_degree: int | None = None,
    background_color: jax.Array | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    return_aux: bool = False,
    return_depth: bool = False,
    viewport_rows: tuple[jax.Array | int, int] | None = None,
    means2d_offset: jax.Array | None = None,
    absgrad_sink: jax.Array | None = None,
):
    """Render 3D gaussians to an (H, W, C) image.

    ``return_depth=True`` additionally returns the (H, W) accumulated depth
    map sum_i(w_i * z_i) (alpha-blend weights w_i, camera-space depth z_i) —
    blended as a fourth channel through the same kernels, differentiable
    back to ``means3d``. The expected depth used for depth supervision is
    ``depth / (1 - aux.raster.final_transmittance)``. (gsplat's 'D'/'ED'
    render modes; the reference discards even the alpha map its kernels
    produce, rasterization.py:124.) Return value becomes ``(image, depth)``
    (plus aux last if ``return_aux``).

    Same public surface as the reference orchestrator (render.py:12-43); the
    backend argument moves into ``config.raster_impl`` and ``config`` replaces the
    loose tile_size argument with the full numerical contract.

    ``viewport_rows=(row0, height)`` renders only image rows
    [row0, row0+height) — the tile-row slab primitive used by the sharded
    renderer (parallel/sharding.py). Projection always uses the *full* camera
    (so guard-band clamps, culling and conics are bit-identical to a full
    render); only binning and rasterization are restricted to the slab, by
    shifting screen-space y. ``row0`` may be a traced value (e.g. derived from
    ``jax.lax.axis_index`` inside shard_map); ``height`` must be static and a
    multiple of the tile size.
    """
    if sh_degree is None:
        if features.ndim != 2:
            raise ValueError(
                f"RGB features must be (N, C), got {features.shape}; pass "
                "sh_degree for SH coefficients"
            )
        colors = features
    else:
        if features.ndim != 3:
            raise ValueError(
                f"SH features must be (N, K, C), got {features.shape}"
            )
        colors = sh_to_color(features, means3d, camera.position, sh_degree)

    num_channels = colors.shape[-1]
    if background_color is None:
        background = jnp.zeros((num_channels,), dtype=colors.dtype)
    else:
        background = jnp.asarray(background_color, dtype=colors.dtype)
        if background.shape != (num_channels,):
            raise ValueError(
                f"Background color channels {background.shape} must match "
                f"feature channels ({num_channels},)"
            )

    if opacities.shape != (means3d.shape[0],):
        raise ValueError(
            f"opacities must be (N,) = ({means3d.shape[0]},), got "
            f"{opacities.shape}"
        )

    proj = project_gaussians(means3d, scales, quats, opacities, camera, config)

    if means2d_offset is not None:
        # A zero (N, 2) parameter whose cotangent is the view-space
        # positional gradient — the densification statistic of 3DGS
        # training (densify.py accumulates its norm).
        proj = proj._replace(means2d=proj.means2d + means2d_offset)
    # absgrad_sink: like means2d_offset but its cotangent is the ABSOLUTE
    # per-tile view-space gradient (AbsGS/gsplat absgrad; see
    # ops/rasterization._abs_tap). Does not affect the forward.

    if viewport_rows is None:
        means2d, out_h = proj.means2d, camera.H
    else:
        row0, out_h = viewport_rows
        if out_h % config.tile_size != 0:
            raise ValueError(
                f"viewport height {out_h} must be a multiple of tile_size "
                f"{config.tile_size}"
            )
        # Shift screen-space y so the slab starts at row 0; geometry
        # (conics/radii/depths/culling) is untouched.
        shift = jnp.stack(
            [jnp.zeros((), proj.means2d.dtype),
             jnp.asarray(row0, proj.means2d.dtype)]
        )
        means2d = proj.means2d - shift[None, :]

    if config.antialiased:
        # Mip-Splatting opacity compensation (differentiable; see
        # RenderConfig.antialiased). Radii/culling above stay on the raw
        # opacity, which is conservative (never smaller footprints).
        opacities = opacities * proj.compensations

    binning = bin_gaussians_to_tiles(
        means2d, proj.radii, proj.depths, out_h, camera.W, config,
        conics=proj.conics, opacities=opacities,
    )
    if return_depth:
        # Blend camera-space depth as a fourth channel (zero background):
        # the kernels' aux channel slot, so depth costs no extra pass.
        colors = jnp.concatenate(
            [colors, proj.depths[:, None].astype(colors.dtype)], axis=-1
        )
        background = jnp.concatenate(
            [background, jnp.zeros((1,), background.dtype)]
        )
    image, raster_aux = rasterize_gaussians(
        means2d,
        proj.conics,
        colors,
        opacities,
        background,
        binning,
        out_h,
        camera.W,
        config,
        absgrad_sink=absgrad_sink,
    )
    out = (image,)
    if return_depth:
        out = (image[..., :num_channels], image[..., num_channels])
    if return_aux:
        out = out + (RenderAux(binning=binning.aux, raster=raster_aux),)
    return out[0] if len(out) == 1 else out
