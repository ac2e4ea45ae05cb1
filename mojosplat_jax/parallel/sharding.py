"""Multi-device sharding: camera-DP x tile-row-SP over a jax.sharding.Mesh.

The reference has no distributed code of any kind (SURVEY.md section 2.3: no
process groups, no torch.distributed; its only trace is a commented-out
world_rank print, /root/reference/mojosplat/binning.py:83, and a dormant
camera dimension in the kernels, kernels/projection.mojo:14). This module
introduces the equivalents the survey calls for:

  - **Camera/view data parallelism** ('data' axis): a batch of cameras is
    sharded across devices — the reference's dormant ``C`` dimension made real.
  - **Tile-space parallelism** ('tile' axis) — the renderer's analogue of
    sequence/context parallelism (SURVEY.md section 5): each device renders a
    horizontal slab of tile rows via ``render_gaussians(viewport_rows=...)``.
    Projection runs against the full camera on every device (so conics and
    culling are bit-identical to a single-device render); only binning and
    rasterization are restricted to the slab, and the binning cull discards
    gaussians that miss it.
  - **Gaussian-axis parallelism**: the (N,) parameter arrays sharded for the
    embarrassingly-parallel projection stage, compact projected outputs
    all-gathered (``project_gaussians_sharded``) — the TP row of SURVEY.md
    section 2.3.

Gradients are combined with ``jax.lax.psum`` over both mesh axes (see
train.py) — XLA collectives, which it hands to NCCL (SURVEY.md section
2.3). Multi-host extends the same mesh via
``jax.distributed.initialize()`` (the mesh helper just sees more devices).
"""

from __future__ import annotations

from typing import Any

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..camera import Camera
from ..config import DEFAULT_CONFIG, RenderConfig
from ..ops.projection import ProjectionResult, project_gaussians
from ..render import render_gaussians

shard_map = jax.shard_map


def make_mesh(n_data: int, n_tile: int, devices=None) -> Mesh:
    """Build a ('data', 'tile') mesh from the first n_data*n_tile devices."""
    if devices is None:
        devices = jax.devices()
    need = n_data * n_tile
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    arr = np.asarray(devices[:need]).reshape(n_data, n_tile)
    return Mesh(arr, ("data", "tile"))


def check_slab_divisibility(H: int, n_tile: int, config: RenderConfig) -> int:
    ts = config.tile_size
    if H % (n_tile * ts) != 0:
        raise ValueError(
            f"image height {H} must be divisible by tile-axis size {n_tile} "
            f"x tile_size {ts}"
        )
    return H // n_tile


def render_slabs(
    params: dict[str, Any],
    cameras: Camera,  # batched: every data field has leading axis B_local
    slab_h: int,
    sh_degree: int | None,
    background_color,
    config: RenderConfig,
    primitive: str = "3dgs",
) -> jax.Array:
    """Per-device body: render this device's tile-row slab of each local
    camera. Must run inside shard_map with a 'tile' axis.

    ``primitive``: "3dgs" (render_gaussians) or "2dgs" (render_surfels) —
    both families share the slab/viewport_rows contract."""
    row0 = jax.lax.axis_index("tile") * slab_h
    if primitive == "3dgs":
        render = render_gaussians
    elif primitive == "2dgs":
        from ..surfel import render_surfels

        render = render_surfels
    else:
        raise ValueError(f"Unknown primitive: {primitive!r}")

    def render_one(cam: Camera) -> jax.Array:
        return render(
            params["means3d"],
            params["scales"],
            params["quats"],
            params["opacities"],
            params["features"],
            cam,
            sh_degree=sh_degree,
            background_color=background_color,
            config=config,
            viewport_rows=(row0, slab_h),
        )

    return jax.vmap(render_one)(cameras)


def render_batch_sharded(
    params: dict[str, Any],
    cameras: Camera,
    mesh: Mesh,
    sh_degree: int | None = None,
    background_color=None,
    config: RenderConfig = DEFAULT_CONFIG,
    primitive: str = "3dgs",
) -> jax.Array:
    """Render B cameras over the mesh; returns the (B, H, W, C) images,
    sharded (B over 'data', rows over 'tile')."""
    slab_h = check_slab_divisibility(cameras.H, mesh.shape["tile"], config)

    fn = shard_map(
        lambda p, c: render_slabs(
            p, c, slab_h, sh_degree, background_color, config, primitive
        ),
        mesh=mesh,
        in_specs=(P(), P("data")),
        out_specs=P("data", "tile"),
        check_vma=False,
    )
    return fn(params, cameras)


def project_gaussians_sharded(
    means3d: jax.Array,
    scales: jax.Array,
    quats: jax.Array,
    opacities: jax.Array,
    camera: Camera,
    mesh: Mesh,
    axis: str = "tile",
    config: RenderConfig = DEFAULT_CONFIG,
) -> ProjectionResult:
    """Projection with the N-gaussian arrays sharded over a mesh axis.

    Projection is embarrassingly parallel over N (one thread per gaussian in
    the reference, projection.mojo:308-310), so each device projects its shard
    and the compact outputs (8 floats/gaussian) are all-gathered — far cheaper
    than gathering the raw parameters when SH coefficients are attached.
    """
    n_shards = mesh.shape[axis]
    N = means3d.shape[0]
    if N % n_shards != 0:
        raise ValueError(f"N={N} must be divisible by {axis} axis ({n_shards})")

    def shard_fn(m, s, q, o):
        res = project_gaussians(m, s, q, o, camera, config)
        return jax.tree_util.tree_map(
            lambda x: jax.lax.all_gather(x, axis, axis=0, tiled=True), res
        )

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )
    return fn(means3d, scales, quats, opacities)
