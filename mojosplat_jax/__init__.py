"""mojosplat_jax: a 3D Gaussian Splatting framework in JAX, run on NVIDIA GPUs.

Brand-new implementation of the capability surface of bertaveira/mojosplat:
  - the three-stage pipeline (EWA projection -> tile binning -> depth-ordered
    alpha-compositing rasterization) as fused, static-shape XLA programs,
    with the rasterizer also as Pallas kernels for the GPU,
  - a full backward pass via plain autodiff (the reference is forward-only),
  - SH color evaluation degrees 0-3 (a reference TODO),
  - padded-bucket binning so scene changes never recompile (the reference
    JIT-specializes per intersection count, README.md:27),
  - multi-device sharding via jax.sharding / shard_map (no reference analogue).
"""

from .bilagrid import (
    apply_bilateral_grid,
    bilateral_grid_tv,
    identity_bilateral_grid,
)
from .camera import Camera, apply_pose_delta, look_at
from .config import DEFAULT_CONFIG, RenderConfig
from .render import RenderAux, render_gaussians
from .surfel import render_surfels

__all__ = [
    "Camera",
    "apply_pose_delta",
    "look_at",
    "RenderConfig",
    "DEFAULT_CONFIG",
    "render_gaussians",
    "render_surfels",
    "RenderAux",
    "apply_bilateral_grid",
    "bilateral_grid_tv",
    "identity_bilateral_grid",
]

__version__ = "0.1.0"
