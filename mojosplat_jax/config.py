"""Render configuration: the numerical contract of the pipeline.

Every constant that the reference scatters across files is gathered here so the
whole pipeline shares one frozen, hashable config (usable as a jit static arg).

Reference provenance (``/root/reference``):
  - ``tile_size = 16``: render.py:9
  - ``eps2d = 0.3``: projection.py:334, kernels/projection.mojo:209
  - ``alpha_threshold = 1/255``: kernels/projection.mojo:74,
    kernels/rasterization.mojo:13
  - ``max_alpha = 0.999``: kernels/rasterization.mojo:143
  - ``transmittance_eps = 1e-4`` (early termination): kernels/rasterization.mojo:148
  - ``radius_extend = 3.33``: projection.py:266-267, kernels/projection.mojo:214
  - ``radius_clip = 0.0``: kernels/projection.mojo:9
  - opacity-aware radius (gsplat CUDA semantics): kernels/projection.mojo:214-226.
    The reference's torch backend uses the plain 3.33 radius instead
    (projection.py:266-267); we follow the gsplat/mojo variant by default because
    gsplat is the correctness oracle (SURVEY.md section 7 "hard parts"), with a
    flag to reproduce the torch variant.
  - near/far plane taken from the camera (projection.py:335-336), fixing the
    mojo kernel's hardcoded ``near_plane=0.1`` divergence
    (kernels/projection.mojo:59) noted in SURVEY.md.

Static-shape budgets (no reference equivalent — these exist to keep all shapes
static so XLA never recompiles across scenes/frames, unlike the reference which
JIT-specializes per (N, H, W, NIntersections), README.md:27):
  - ``max_tile_span``: per-gaussian tile footprint cap (per axis).
  - ``isect_padding_multiplier``: intersection-buffer capacity as a multiple of N.
  - ``tile_capacity``: per-tile dense-table capacity for the reference rasterizer.
  - ``chunk_size``: gaussians blended per vectorized chunk.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # --- shared numerical contract (gsplat parity) ---
    tile_size: int = 16
    eps2d: float = 0.3
    alpha_threshold: float = 1.0 / 255.0
    max_alpha: float = 0.999
    transmittance_eps: float = 1e-4
    radius_extend: float = 3.33
    radius_clip: float = 0.0
    opacity_aware_radius: bool = True
    # gsplat's "antialiased" rasterization mode (Mip-Splatting opacity
    # compensation): blending opacity is scaled by
    # sqrt(det(cov2d) / det(cov2d + eps2d*I)) so the eps2d dilation conserves
    # each splat's integrated energy. The reference always runs the classic
    # mode (its gsplat calls pass no compensation flags, projection.py:381-397
    # / rasterization.py:109-122); this exposes the oracle library's other
    # mode as a config switch.
    antialiased: bool = False
    # Projection linearization: "ewa" (the reference's scheme) or "ut" — the
    # 3DGUT unscented-transform alternative the reference's README lists as
    # desired future work (README.md "Unscented Projection" contribution
    # item): sigma points of the 3D gaussian are pushed through the exact
    # pinhole map and the 2D moments recovered from them, replacing the
    # first-order EWA Jacobian. Standard UT weights (alpha, beta, kappa).
    projection_mode: str = "ewa"
    ut_alpha: float = 1.0
    ut_beta: float = 2.0
    ut_kappa: float = 0.0
    # Rolling-shutter row-time fixed-point iterations (Camera.shutter ==
    # "rolling"; each sigma point solves t = row(project(pose(t) @ p)) / H
    # through the exact camera map — 3DGUT's formulation). 2 converges for
    # sub-frame motion; bump for extreme velocities.
    rs_iterations: int = 2

    # --- static-shape budget knobs (avoid recompiles) ---
    # Max tiles a single gaussian may claim along each axis; larger footprints
    # are truncated symmetrically around the center tile (overflow is counted
    # and surfaced in aux outputs, never silent — unlike binning.py:202-206).
    # 32 tiles x 16 px = a 512-px box; raise for scenes with huge close-up
    # gaussians. Since binning expands intersections by prefix sums, compute
    # cost is independent of this budget — it only bounds how much of the
    # intersection capacity one pathological gaussian can claim.
    max_tile_span: int = 32
    # Intersection buffer capacity = isect_padding_multiplier * N (rounded up
    # to a multiple of 1024); entries past capacity are dropped and counted.
    isect_padding_multiplier: int = 4
    # Tight contribution-aware intersection culling (3DGS conic path only):
    # candidate tiles of the AABB whose peak alpha over the tile's pixel
    # extent cannot reach alpha_threshold are never emitted (the blend
    # kernels would zero them anyway, so this is image/gradient-neutral
    # short of budget overflow — under overflow it improves which slots
    # survive). The reference's AABB test admits ~30-50% such slots for
    # anisotropic splats (/root/reference/mojosplat/binning.py:138-155).
    # Requires max_tile_span <= 8 (the candidate bitmask is 3x22 bits).
    tight_cull: bool = False
    # Dense per-tile table capacity for the pure-JAX tiled rasterizer.
    tile_capacity: int = 512
    # Gaussians blended per vectorized chunk inside the rasterizer.
    chunk_size: int = 64
    # Tiles rasterized per step: None vmaps over all tiles at once (small
    # images); an int scans over groups of that many tiles, bounding the
    # rasterizer's working set to tile_batch * tile_size^2 * chunk_size
    # elements per intermediate (needed at 1080p+ scale).
    tile_batch: int | None = None
    # Rematerialize the per-chunk blend in the backward pass (jax.checkpoint):
    # trades ~2x blend FLOPs for O(pixels) instead of O(pixels * gaussians)
    # residual memory — required for 1080p fwd+bwd to fit in HBM.
    remat: bool = True

    # --- rasterizer implementation selection ---
    # "xla": the pure-XLA scan/vmap route (runs everywhere; the oracle).
    # "pallas": the GPU kernels of ops/raster_triton.py (Pallas, Triton
    #   route) with per-tile trip counts and early exit. 3DGS only.
    raster_impl: str = "xla"
    # Run the Pallas kernels in the Pallas interpreter: a test switch for
    # machines without a GPU, never chosen automatically.
    pallas_interpret: bool = False

    def __post_init__(self):
        if self.tile_size <= 0:
            raise ValueError(f"tile_size must be positive, got {self.tile_size}")
        if self.tile_capacity % self.chunk_size != 0:
            raise ValueError(
                "tile_capacity must be a multiple of chunk_size, got "
                f"{self.tile_capacity} % {self.chunk_size}"
            )


DEFAULT_CONFIG = RenderConfig()
