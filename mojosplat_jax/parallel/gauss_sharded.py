"""Gaussian-sharded end-to-end pipeline: all-to-all intersection routing.

The blueprint's tensor-parallel row (SURVEY.md section 2.3: "the N-gaussian
parameter arrays sharded over a 'gauss' mesh axis; projection is
embarrassingly parallel over N so it runs fully sharded; binning does an
all-to-all to route (tile, depth, gauss) keys to tile owners"). Unlike the
camera-DP x tile-SP path (sharding.py), *nothing here is replicated*: each
device owns N/G gaussians (parameters, optimizer moments, gradients) and one
horizontal slab of tile rows, so the maximum scene size scales with the
TOTAL HBM of the mesh, not one chip's.

Per-device dataflow (inside shard_map over a 1D ('gauss',) mesh):

  1. project + SH-evaluate the LOCAL gaussian shard (local compute only);
  2. bin the local shard against the FULL tile grid (ops/binning.py — its
     (tile, depth)-sorted output is destination-contiguous, because tile
     owners are contiguous tile-row slabs);
  3. slice the sorted slot list into per-destination windows of a static
     ``cap_pair`` (imbalance beyond the window is counted, never silent) and
     gather each slot's blend fields (means2d, conic, opacity, colors) from
     the local arrays — the routed payload is FIELDS, not ids, since no
     other device holds this shard's parameters;
  4. ``jax.lax.all_to_all`` routes the windows to their tile owners (XLA
     hands it to NCCL) — the reference has no distributed code at all
     (SURVEY.md 2.3);
  5. the receiver merges the G incoming depth-sorted streams with one
     stable (tile, depth) sort and rasterizes its slab by treating each
     received slot as a PSEUDO-GAUSSIAN: the merged per-slot fields plus an
     identity id list form a BinningResult, so the unchanged production
     rasterizer (XLA or Pallas, ops/rasterization.py) consumes them.

The backward needs no hand-written communication: autodiff transposes the
all_to_all (slot cotangents return to the shard that owns the gaussian) and
the local gathers (scatter-add into the local shard), so per-gaussian
gradients are BORN sharded — the reduce-scatter the blueprint asks for
falls out of the routing structure instead of being a separate collective.
Only the scalar loss is psum'd. The optimizer step is fully local (ZeRO-3:
moments sharded with the parameters).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from ..camera import Camera
from ..config import DEFAULT_CONFIG, RenderConfig
from ..ops.binning import BinningAux, BinningResult, isect_capacity, num_tiles
from ..ops.binning import bin_gaussians_to_tiles
from ..ops.projection import project_gaussians
from ..ops.rasterization import RasterAux, rasterize_gaussians
from ..ops.sh import sh_to_color

shard_map = jax.shard_map


class RouteAux(NamedTuple):
    """Observability counters for the routed pipeline (all int32 scalars,
    mesh-summed)."""

    num_isects: jax.Array  # slots routed and rasterized
    capacity_overflow: jax.Array  # dropped by per-shard binning capacity
    span_truncated: jax.Array  # tile slots lost to per-gaussian span cap
    route_overflow: jax.Array  # dropped by the per-(src, dst) window cap
    tile_overflow: jax.Array  # dropped by per-tile capacity at the receiver


def make_gauss_mesh(n_devices: int, devices=None) -> Mesh:
    """1D ('gauss',) mesh: each device owns a parameter shard AND the
    matching tile-row slab (axis index = slab index)."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n_devices]), ("gauss",))


def route_pair_capacity(n_local: int, n_dev: int,
                        config: RenderConfig) -> int:
    """Static per-(source, destination) window size for the all_to_all.

    A perfectly balanced scene sends capacity/G slots to each owner; the 2x
    factor absorbs skew (a scene concentrated in one slab) before the
    route_overflow counter starts reporting drops.
    """
    cap = isect_capacity(n_local, config)
    per = 2 * cap // max(n_dev, 1)
    return max(128, -(-per // 128) * 128)


def _route_slots(params, camera, sh_degree, config, axis_name, n_dev):
    """Steps 1-4: project/bin the local shard, route slot fields to owners.

    Returns (fields (R, M) field-major, ltile (M,), depth (M,), counters)
    where
    M = n_dev * cap_pair are this device's RECEIVED slots, ltile is the
    slab-local flat tile id (sentinel = local tile count), and R = 6 + C.
    """
    means3d = params["means3d"]
    features = params["features"]
    n_local = means3d.shape[0]
    H, W = camera.H, camera.W
    th, tw = num_tiles(H, W, config.tile_size)
    n_tiles = th * tw
    if th % n_dev != 0:
        raise ValueError(
            f"tile rows ({th}) must divide evenly over the gauss axis "
            f"({n_dev})"
        )
    tiles_per_slab = (th // n_dev) * tw

    if sh_degree is None:
        colors = features
    else:
        colors = sh_to_color(features, means3d, camera.position, sh_degree)
    C = colors.shape[-1]

    proj = project_gaussians(
        means3d, params["scales"], params["quats"], params["opacities"],
        camera, config,
    )
    opacities = params["opacities"]
    if config.antialiased:
        opacities = opacities * proj.compensations
    binning = bin_gaussians_to_tiles(
        proj.means2d, proj.radii, proj.depths, H, W, config,
        conics=proj.conics, opacities=opacities,
    )

    # Per-slot blend fields from the LOCAL shard (slot -> local gaussian
    # id), field-major (R, X): one row per field, one gather.
    gids = jax.lax.stop_gradient(binning.gaussian_ids)
    safe = jnp.clip(gids, 0, n_local - 1)
    valid = gids >= 0
    field_cols = [
        proj.means2d[:, 0], proj.means2d[:, 1],
        proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
        opacities,
    ] + [colors[:, c] for c in range(C)]
    fields_n = jnp.stack(
        [c.astype(jnp.float32) for c in field_cols], axis=0
    )  # (R, n_local) field-major
    slot_fields = jnp.where(
        valid[None, :], fields_n.T[safe].T, 0.0
    )  # (R, cap_local)
    slot_depth = jax.lax.stop_gradient(
        jnp.where(valid, proj.depths[safe], jnp.inf)
    )
    slot_tile = binning.tile_ids  # sentinel n_tiles on padding

    # Destination windows: the sorted slot list is already grouped by owner
    # (owners are contiguous tile ranges), so each destination's slots are
    # one contiguous run [starts[d], starts[d+1]).
    bounds = jnp.searchsorted(
        slot_tile,
        jnp.arange(n_dev + 1, dtype=jnp.int32) * tiles_per_slab,
        side="left",
    ).astype(jnp.int32)
    counts = bounds[1:] - bounds[:-1]
    cap_pair = route_pair_capacity(n_local, n_dev, config)
    route_overflow = jnp.sum(jnp.maximum(counts - cap_pair, 0))

    def window(arr, fill):
        # Windows slice along the SLOT axis (the last one).
        axis = arr.ndim - 1
        pad_width = [(0, 0)] * axis + [(0, cap_pair)]
        padded = jnp.pad(arr, pad_width, constant_values=fill)

        def one(start):
            return jax.lax.dynamic_slice_in_dim(padded, start, cap_pair,
                                                axis)

        return jax.vmap(one)(bounds[:-1])  # (n_dev, ..., cap_pair)

    j = jnp.arange(cap_pair, dtype=jnp.int32)
    in_win = j[None, :] < jnp.minimum(counts, cap_pair)[:, None]
    w_fields = jnp.where(
        in_win[:, None, :], window(slot_fields, 0.0), 0.0
    )  # (n_dev, R, cap_pair)
    w_tile = jnp.where(in_win, window(slot_tile, n_tiles), n_tiles)
    w_depth = jnp.where(in_win, window(slot_depth, jnp.inf), jnp.inf)

    # All-to-all: window d goes to device d; we receive one window from
    # every source. Autodiff transposes this collective, returning slot
    # cotangents to the shard that owns each gaussian. Splitting along the
    # slot axis keeps the field-major layout through the collective.
    def a2a(x, split_axis):
        return jax.lax.all_to_all(
            x, axis_name, split_axis=split_axis, concat_axis=split_axis,
            tiled=True,
        )

    r_fields = a2a(
        jnp.swapaxes(w_fields, 0, 1).reshape(-1, n_dev * cap_pair), 1
    )  # (R, M)
    r_tile = a2a(w_tile.reshape(-1), 0)  # (M,)
    r_depth = a2a(w_depth.reshape(-1), 0)

    # Global -> slab-local tile ids; anything not in my slab (only padding,
    # by construction) goes to the local sentinel.
    my_tile0 = jax.lax.axis_index(axis_name) * tiles_per_slab
    lt = r_tile - my_tile0
    ltile = jnp.where((lt >= 0) & (lt < tiles_per_slab), lt, tiles_per_slab)

    counters = RouteAux(
        num_isects=jnp.sum(ltile < tiles_per_slab).astype(jnp.int32),
        capacity_overflow=binning.aux.capacity_overflow,
        span_truncated=binning.aux.span_truncated,
        route_overflow=route_overflow.astype(jnp.int32),
        tile_overflow=jnp.int32(0),  # filled by the rasterizer below
    )
    return r_fields, ltile, r_depth, counters


def _rasterize_routed(fields, ltile, depth, camera, slab_h, config,
                      background, C):
    """Step 5: merge the received streams and rasterize this device's slab.

    One stable (tile, depth) sort merges the G depth-sorted source streams;
    the sorted per-slot fields + an identity id list form a pseudo-gaussian
    scene for the unchanged rasterizer.
    """
    M = fields.shape[1]
    th_l, tw = num_tiles(slab_h, camera.W, config.tile_size)
    lt_sorted, _, perm = jax.lax.sort(
        (ltile, depth, jnp.arange(M, dtype=jnp.int32)),
        num_keys=2,
        is_stable=True,
    )
    # Differentiable column take (perm is structural); transposes around
    # the row gather are layout bitcasts, keeping (R, M) field-major.
    fields_s = fields.T[perm].T

    boundaries = jnp.searchsorted(
        lt_sorted, jnp.arange(th_l * tw + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    tile_ranges = jnp.stack(
        [boundaries[:-1], boundaries[1:]], axis=-1
    ).reshape(th_l, tw, 2)

    pad = lt_sorted >= th_l * tw
    pseudo = BinningResult(
        gaussian_ids=jnp.where(pad, -1, jnp.arange(M, dtype=jnp.int32)),
        tile_ids=lt_sorted,
        tile_ranges=tile_ranges,
        aux=BinningAux(
            num_isects=boundaries[-1],
            capacity_overflow=jnp.int32(0),
            span_truncated=jnp.int32(0),
            tight_culled=jnp.int32(0),
        ),
    )
    # The rasterizer's public surface takes slot-minor slices; it re-packs
    # them into field-major columns immediately (gather_tile_data), so XLA
    # fuses these transposed views without materializing (M, <128) buffers.
    return rasterize_gaussians(
        fields_s[0:2].T,
        fields_s[2:5].T,
        fields_s[6:6 + C].T,
        fields_s[5],
        background,
        pseudo,
        slab_h,
        camera.W,
        config,
    )


def _render_slab(params, camera, sh_degree, config, background, axis_name,
                 n_dev, slab_h):
    """Full per-device body: route + rasterize. Runs inside shard_map."""
    C = params["features"].shape[-1]  # (N, C) RGB or (N, K, C) SH
    fields, ltile, depth, counters = _route_slots(
        params, camera, sh_degree, config, axis_name, n_dev
    )
    if background is None:
        bg = jnp.zeros((C,), jnp.float32)
    else:
        bg = jnp.asarray(background, jnp.float32)
    # Routed means2d are global image coordinates; the receiver rasterizes
    # a slab whose rows start at 0 — shift screen-space y into slab space
    # (the same shift render_gaussians applies for viewport_rows).
    row0 = (jax.lax.axis_index(axis_name) * slab_h).astype(fields.dtype)
    fields = fields.at[1, :].add(-row0)
    image, raster_aux = _rasterize_routed(
        fields, ltile, depth, camera, slab_h, config, bg, C
    )
    counters = counters._replace(tile_overflow=raster_aux.tile_overflow)
    counters = jax.tree_util.tree_map(
        lambda c: jax.lax.psum(c, axis_name), counters
    )
    return image, counters


def render_gaussians_sharded(
    params: dict[str, Any],  # activated; every leaf sharded on axis 0
    camera: Camera,
    mesh: Mesh,
    sh_degree: int | None = None,
    background_color=None,
    config: RenderConfig = DEFAULT_CONFIG,
    return_aux: bool = False,
):
    """Render with gaussians AND tiles sharded over a ('gauss',) mesh.

    Returns the (H, W, C) image (rows sharded over the mesh) and, with
    ``return_aux``, the mesh-summed RouteAux counters (replicated).
    """
    n_dev = mesh.shape["gauss"]
    if camera.H % (n_dev * config.tile_size) != 0:
        raise ValueError(
            f"image height {camera.H} must divide into {n_dev} slabs of "
            f"whole {config.tile_size}-px tile rows"
        )
    slab_h = camera.H // n_dev

    fn = shard_map(
        lambda p, cam: _render_slab(
            p, cam, sh_degree, config, background_color, "gauss", n_dev,
            slab_h,
        ),
        mesh=mesh,
        in_specs=(P("gauss"), P()),
        out_specs=(P("gauss"), P()),
        check_vma=False,
    )
    image, counters = fn(params, camera)
    if return_aux:
        return image, counters
    return image


def _sharded_opt_spec(tree):
    """Shard every rank>=1 optimizer-state leaf's leading (gaussian) axis;
    scalars (Adam's count) stay replicated."""
    return jax.tree_util.tree_map(
        lambda x: P("gauss") if getattr(x, "ndim", 0) >= 1 else P(), tree
    )


def train_step_gauss_sharded(
    state,  # train.TrainState with every param/moment leaf sharded on axis 0
    camera: Camera,
    target: jax.Array,  # (H, W, C), rows sharded over 'gauss'
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
):
    """One fully-sharded training step (ZeRO-3 over the 'gauss' axis).

    Parameters, gradients and optimizer moments all stay sharded: the
    backward of the routed pipeline delivers each device exactly its own
    shard's gradients (the all_to_all transpose — no psum of parameter
    gradients, the "reduce-scattered grads" of SURVEY.md section 2.3), and
    the optimizer step is local. Only the scalar loss crosses the mesh.
    """
    from ..train import TrainState, activate  # local import: no cycle

    n_dev = mesh.shape["gauss"]
    if camera.H % (n_dev * config.tile_size) != 0:
        # Same contract as render_gaussians_sharded: a height divisible by
        # n_dev but not by whole tile rows would bin against global tiles
        # while rasterizing misaligned slabs — silently wrong training.
        raise ValueError(
            f"image height {camera.H} must divide into {n_dev} slabs of "
            f"whole {config.tile_size}-px tile rows"
        )
    slab_h = camera.H // n_dev
    denom = float(target.size)

    def shard_fn(params, opt_state, step, cam, tgt):
        def loss_fn(raw):
            image, _ = _render_slab(
                activate(raw), cam, sh_degree, config, None, "gauss",
                n_dev, slab_h,
            )
            # LOCAL loss only. The cross-device dependency lives in the
            # forward all_to_all, so its transpose already returns this
            # shard's contributions to every slab's error — the local
            # gradient IS the global gradient. (A psum inside the
            # differentiated function would 8x the grads: with
            # check_vma=False the transpose of psum is psum, not
            # pbroadcast.)
            return jnp.sum((image - tgt) ** 2) / denom

        local_loss, grads = jax.value_and_grad(loss_fn)(params)
        loss = jax.lax.psum(local_loss, "gauss")
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, step + 1, loss

    os_spec = _sharded_opt_spec(state.opt_state)
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P("gauss"), os_spec, P(), P(), P("gauss")),
        out_specs=(P("gauss"), os_spec, P(), P()),
        check_vma=False,
    )
    params, opt_state, step, loss = fn(
        state.params, state.opt_state, state.step, camera, target
    )
    return TrainState(params, opt_state, step), loss
