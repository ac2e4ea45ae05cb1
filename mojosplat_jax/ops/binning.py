"""Tile binning: gaussian -> (tile, depth)-sorted intersection lists (pure XLA).

Replaces both reference backends with a single fully-vectorized XLA program:
  - the gsplat CUDA path (isect_tiles radix sort + isect_offset_encode,
    /root/reference/mojosplat/binning.py:41-102), and
  - the torch path's Python double loop over gaussians x tiles
    (binning.py:170-209) and two-pass stable argsort (binning.py:217-231).

All shapes are *static* (SURVEY.md section 7), so changing
scenes never recompiles — unlike the reference, which JIT-specializes its
rasterizer on the intersection count every frame (rasterization.py:177,
README.md:27). Three static budgets bound the dynamic quantities:

  1. ``max_tile_span`` caps the per-gaussian tile footprint per axis; larger
     footprints are truncated symmetrically around the gaussian's center tile.
  2. ``capacity`` caps the total intersection count. Slots are emitted in
     depth order, so overflow drops the FARTHEST-depth intersections first —
     the ones most likely already occluded — rather than an arbitrary
     index-based subset.
  3. Padding entries carry the sentinel ``tile_id == n_tiles`` which sorts past
     every real tile, so downstream range lookups need no masking.

Both truncation and capacity overflow are *counted and surfaced* in the aux
output instead of silently printed and dropped (binning.py:202-206).

The route: a small N-row presort by (is_empty, depth) makes slot emission
depth-ascending and compacts nonzero-count gaussians to a prefix; a
scatter of one head per gaussian plus a cumsum recovers each slot's owner;
one packed row gather; and a single stable lexicographic sort on
(tile_id, depth).

Tile ranges come from one vectorized ``searchsorted`` (binning.py:252-256).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import DEFAULT_CONFIG, RenderConfig


class BinningAux(NamedTuple):
    """Observability counters (all traced scalars, int32)."""

    num_isects: jax.Array  # real intersections kept (<= capacity)
    capacity_overflow: jax.Array  # intersections dropped because buffer filled
    span_truncated: jax.Array  # tile slots lost to per-gaussian span capping
    # AABB slots proven zero-contribution by the tight conic-vs-tile test
    # (tight_cull mode; 0 otherwise). Unlike the two counters above these
    # are never lost work: the blend kernels would have zeroed them anyway.
    tight_culled: jax.Array


class BinningResult(NamedTuple):
    """Sorted intersection lists plus per-tile ranges.

    gaussian_ids: (capacity,) int32 gaussian index per intersection, sorted by
        (tile, depth); padding entries are -1.
    tile_ids: (capacity,) int32 flat tile id per entry; padding = n_tiles.
    tile_ranges: (tiles_h, tiles_w, 2) int32 [start, end) into the sorted lists
        (same layout as the reference's tile_ranges, binning.py:258-260).
    aux: BinningAux counters.
    """

    gaussian_ids: jax.Array
    tile_ids: jax.Array
    tile_ranges: jax.Array
    aux: BinningAux


# Bits of tile-candidate mask per f32 payload row. 22 keeps every mask row
# an exact non-negative integer in the f32 row gather.
_MASK_BITS = 22
# Tight culling stores one bit per candidate tile of the span x span
# rectangle in at most 3 mask rows, so it supports max_tile_span <= 8.
_MAX_TIGHT_BITS = 3 * _MASK_BITS


def _rect_min_sigma(a, b, c, inva, invc, lx, hx, ly, hy):
    """Minimum of sigma(u, v) = 0.5(a u^2 + c v^2) + b u v over the
    displacement rectangle [lx, hx] x [ly, hy].

    The conic is positive-definite (eps2d dilation, projection.py), so the
    minimum is 0 when the origin lies inside the rectangle and otherwise
    sits on one of the four edges, where it is a 1D quadratic minimized in
    closed form (clamped vertex).
    """
    def edge_u(u):  # fixed u, minimize over v
        v = jnp.clip(-b * u * invc, ly, hy)
        return 0.5 * (a * u * u + c * v * v) + b * u * v

    def edge_v(v):
        u = jnp.clip(-b * v * inva, lx, hx)
        return 0.5 * (a * u * u + c * v * v) + b * u * v

    q = jnp.minimum(
        jnp.minimum(edge_u(lx), edge_u(hx)),
        jnp.minimum(edge_v(ly), edge_v(hy)),
    )
    inside = (lx <= 0) & (hx >= 0) & (ly <= 0) & (hy >= 0)
    return jnp.where(inside, 0.0, q)


def _tight_tile_masks(means2d, conics, opacities, tx_min, ty_min,
                      span_x, span_y, ts, span, alpha_threshold):
    """Per-gaussian survivor count + candidate bitmasks for tight culling.

    For every candidate tile (kx, ky) of the truncated span x span
    rectangle, a slot survives iff the gaussian's peak alpha over the
    tile's pixel-center extent reaches the blend threshold:
    max_rect opacity * exp(-sigma) >= alpha_threshold. This is exactly the
    keep test the blend kernels apply per pixel (_chunk_geometry /
    _pixel_alphas), evaluated at the continuous rectangle minimum of
    sigma — conservative versus the discrete pixel centers, so a culled
    slot provably contributes zero to every pixel and dropping it is
    image- and gradient-neutral. The reference's AABB admits ~30-50%
    such never-contributing slots for anisotropic splats
    (/root/reference/mojosplat/binning.py:138-155 carries the same AABB).

    Returns (counts (N,) int32, [mask_row (N,) int32, ...]) with bit
    j = ky * span + kx of row j // _MASK_BITS set for survivors.
    """
    mx, my = means2d[:, 0], means2d[:, 1]
    a = conics[:, 0].astype(jnp.float32)
    b = conics[:, 1].astype(jnp.float32)
    c = conics[:, 2].astype(jnp.float32)
    inva = 1.0 / jnp.maximum(a, 1e-12)
    invc = 1.0 / jnp.maximum(c, 1e-12)
    smax = jnp.log(
        jnp.maximum(opacities.astype(jnp.float32), 1e-12) / alpha_threshold
    )
    n_bits = span * span
    n_rows = -(-n_bits // _MASK_BITS)
    masks = [jnp.zeros(mx.shape, jnp.int32) for _ in range(n_rows)]
    counts = jnp.zeros(mx.shape, jnp.int32)
    for j in range(n_bits):
        ky, kx = divmod(j, span)
        lx = (tx_min + kx).astype(jnp.float32) * ts + 0.5 - mx
        hx = lx + (ts - 1)
        ly = (ty_min + ky).astype(jnp.float32) * ts + 0.5 - my
        hy = ly + (ts - 1)
        q = _rect_min_sigma(a, b, c, inva, invc, lx, hx, ly, hy)
        hit = (kx < span_x) & (ky < span_y) & (q <= smax)
        hit_i = hit.astype(jnp.int32)
        counts = counts + hit_i
        masks[j // _MASK_BITS] = masks[j // _MASK_BITS] | (
            hit_i << (j % _MASK_BITS)
        )
    return counts, masks


def _decode_mask_tile(k, mask_rows, span, tw, g_tx, g_ty):
    """Flat tile id of a slot's k-th surviving candidate (k-th set bit of
    the row-major span x span mask). ``cnt == k`` fires exactly once (cnt
    counts set bits strictly before j), so a masked accumulate decodes the
    position without a carry-dependent scan."""
    cnt = jnp.zeros_like(k)
    acc = jnp.zeros_like(k)
    for j in range(span * span):
        bit = (mask_rows[j // _MASK_BITS] >> (j % _MASK_BITS)) & 1
        hit = (bit == 1) & (cnt == k)
        ky, kx = divmod(j, span)
        if ky or kx:
            acc = acc + jnp.where(hit, jnp.int32(ky * tw + kx), 0)
        cnt = cnt + bit
    return g_ty * tw + g_tx + acc


def isect_capacity(n_gaussians: int, config: RenderConfig) -> int:
    """Static intersection-buffer capacity for N gaussians."""
    cap = config.isect_padding_multiplier * max(int(n_gaussians), 1)
    return int(-(-cap // 1024) * 1024)


def num_tiles(img_height: int, img_width: int, tile_size: int) -> tuple[int, int]:
    """Tile grid dims, ceil(H/ts) x ceil(W/ts) (binning.py:26-27)."""
    return math.ceil(img_height / tile_size), math.ceil(img_width / tile_size)


def bin_gaussians_to_tiles(
    means2d: jax.Array,  # (N, 2) pixel-space centers
    radii: jax.Array,  # (N, 2) int32 conservative radii (0 => culled)
    depths: jax.Array,  # (N,) camera-space z
    img_height: int,
    img_width: int,
    config: RenderConfig = DEFAULT_CONFIG,
    capacity: int | None = None,
    conics: jax.Array | None = None,  # (N, 3) for tight culling
    opacities: jax.Array | None = None,  # (N,) for tight culling
) -> BinningResult:
    """Bin gaussians into screen tiles, depth-sorted within each tile.

    Same role as bin_gaussians_to_tiles (binning.py:8-37) without the backend
    dispatch.

    With ``config.tight_cull`` and ``conics``/``opacities`` supplied, each
    candidate tile of the AABB additionally passes the exact conic-vs-tile
    peak-alpha test (_tight_tile_masks): never-contributing slots are not
    emitted at all, so the static capacity holds only slots the blend
    kernels would actually apply. Image/gradient-neutral when nothing
    overflows; under overflow it strictly improves which slots survive.
    """
    N = means2d.shape[0]
    ts = config.tile_size
    span = config.max_tile_span
    th, tw = num_tiles(img_height, img_width, ts)
    n_tiles = th * tw
    if capacity is None:
        capacity = isect_capacity(N, config)
    tight = (
        config.tight_cull and conics is not None and opacities is not None
    )
    if tight and span * span > _MAX_TIGHT_BITS:
        raise ValueError(
            f"tight_cull supports max_tile_span <= 8 (candidate masks are "
            f"{_MAX_TIGHT_BITS} bits); got {span}"
        )

    # Binning output is pure structure (which gaussian lands in which tile,
    # in what order); its gradients are zero by design, matching the
    # reference where binning is index bookkeeping.
    means2d, depths = jax.lax.stop_gradient((means2d, depths))
    if tight:
        conics, opacities = jax.lax.stop_gradient((conics, opacities))

    x, y = means2d[:, 0], means2d[:, 1]
    rx = radii[:, 0].astype(means2d.dtype)
    ry = radii[:, 1].astype(means2d.dtype)
    valid = (radii[:, 0] > 0) & (radii[:, 1] > 0)

    # Tile-space AABB, [min, max) exclusive, clamped to the grid (gsplat
    # isect_tiles convention; the torch backend clamps in pixel space first,
    # binning.py:146-155, which is equivalent at the tile granularity).
    tx_min = jnp.clip(jnp.floor((x - rx) / ts), 0, tw).astype(jnp.int32)
    tx_max = jnp.clip(jnp.ceil((x + rx) / ts), 0, tw).astype(jnp.int32)
    ty_min = jnp.clip(jnp.floor((y - ry) / ts), 0, th).astype(jnp.int32)
    ty_max = jnp.clip(jnp.ceil((y + ry) / ts), 0, th).astype(jnp.int32)

    span_x = jnp.where(valid, tx_max - tx_min, 0)
    span_y = jnp.where(valid, ty_max - ty_min, 0)
    orig_area = span_x * span_y

    # Symmetric truncation to the static per-axis span budget.
    excess_x = jnp.maximum(span_x - span, 0)
    excess_y = jnp.maximum(span_y - span, 0)
    tx_min = tx_min + excess_x // 2
    ty_min = ty_min + excess_y // 2
    span_x = jnp.minimum(span_x, span)
    span_y = jnp.minimum(span_y, span)
    counts = span_x * span_y
    span_truncated = jnp.sum(orig_area - counts)

    if tight:
        counts, cand_masks = _tight_tile_masks(
            means2d, conics, opacities, tx_min, ty_min, span_x, span_y,
            ts, span, config.alpha_threshold,
        )
        tight_culled = jnp.sum(span_x * span_y - counts)
    else:
        cand_masks = []
        tight_culled = jnp.int32(0)

    slot = jnp.arange(capacity, dtype=jnp.int32)
    if N >= (1 << 24):
        raise ValueError(
            "binning packs gaussian indices in f32 (exact below 2^24); "
            f"got N = {N}"
        )
    if max(th, tw) >= (1 << 13) or span >= (1 << 8):
        raise ValueError(
            "binning packs tile coords in 13 bits and spans in 8 "
            f"(grid {th}x{tw}, max_tile_span {span})"
        )

    # Depth presort shared by both routes: ONE f32 key (empty gaussians
    # folded to +inf so they compact to the suffix; their order is
    # irrelevant — they own zero slots) and the per-gaussian geometry
    # bit-packed into two int32 payloads. Sort cost scales per operand
    # (every payload rides every merge pass), so 4 operands instead of the
    # naive 7 (2 keys + 5 fields). Stability preserves the original-index
    # tie-break on equal depths, exactly like the old (is_empty, depth) key
    # pair.
    # NaN depths would sort past the +inf empty suffix (NaN > inf in
    # lax.sort); fold them to the largest finite float so a non-empty
    # gaussian never lands after an empty one.
    depth_key = depths.astype(jnp.float32)
    depth_key = jnp.where(
        jnp.isnan(depth_key), jnp.finfo(jnp.float32).max, depth_key
    )
    sortkey = jnp.where(counts == 0, jnp.inf, depth_key)
    geom = tx_min | (ty_min << 13)
    # Tight mode: survivor count no longer equals the span product, so pack
    # it into the spans payload (counts <= 66 fits bits 16..22); the
    # candidate mask rows ride the presort as extra payload operands.
    spans = span_x | (span_y << 8)
    if tight:
        spans = spans | (counts << 16)
    ops = jax.lax.sort(
        (sortkey, geom, spans, jnp.arange(N, dtype=jnp.int32), *cand_masks),
        num_keys=1,
        is_stable=True,
    )
    depths_p, geom_p, spans_p, index_p = ops[:4]
    masks_p = list(ops[4:])
    tx_min_p = geom_p & 0x1FFF
    ty_min_p = geom_p >> 13
    span_x_p = spans_p & 0xFF
    if tight:
        counts_p = spans_p >> 16
    else:
        counts_p = span_x_p * (spans_p >> 8)
    offsets_p = jnp.cumsum(counts_p) - counts_p  # exclusive prefix sum
    total = jnp.where(
        N > 0, offsets_p[-1] + counts_p[-1], 0
    ).astype(jnp.int32)

    # Depth-presorted emission: when `capacity` overflows, the
    # farthest-depth intersections are the ones dropped.
    offsets = offsets_p

    # Segmented expansion by prefix sums, in place of the reference's
    # per-gaussian emission loop (binning.py:170-209). Each (depth-ranked) gaussian owns the slot range
    # [offsets[i], offsets[i]+counts[i]); instead of scattering every
    # candidate (tile, gaussian) pair (cost ~ N*span^2 scatter updates —
    # measured 15-90x slower than the real intersection count), we
    # scatter-add ONE segment head per gaussian (N updates) and recover
    # the owner of every slot with a cumulative sum:
    #   head[offsets[i]] += 1  =>  rank[j] = cumsum(head)[j] - 1
    # Zero-count gaussians share their offset with the next gaussian;
    # the adds accumulate there and the cumsum resolves each slot to the
    # LAST gaussian starting at-or-before it, which is the unique
    # non-empty owner. Total cost is O(N + capacity), independent of
    # max_tile_span.
    head = jnp.zeros((capacity,), jnp.int32)
    head = head.at[offsets].add(1, mode="drop")
    rank_buf = jnp.cumsum(head) - 1  # (capacity,) owner depth-rank

    in_range = (slot < total) & (rank_buf >= 0)
    safe_rank = jnp.clip(rank_buf, 0, N - 1)
    # One packed row-gather of the per-gaussian fields. Integer fields
    # round-trip exactly through f32: indices are checked below 2^24
    # above, tile coordinates below 2^13, mask rows hold 22 bits.
    fields = jnp.stack(
        [
            offsets.astype(jnp.float32),
            span_x_p.astype(jnp.float32),
            tx_min_p.astype(jnp.float32),
            ty_min_p.astype(jnp.float32),
            depths_p,  # +inf on empty gaussians (never in-range)
            index_p.astype(jnp.float32),
        ]
        + [m.astype(jnp.float32) for m in masks_p],
        axis=-1,
    )  # (N, 6 [+ mask rows]) depth-sorted, compacted-first
    g = fields[safe_rank]  # (capacity, 6 [+ masks])
    g_off = g[:, 0].astype(jnp.int32)
    g_sx = g[:, 1].astype(jnp.int32)
    g_tx = g[:, 2].astype(jnp.int32)
    g_ty = g[:, 3].astype(jnp.int32)
    g_depth = g[:, 4]
    g_gid = g[:, 5].astype(jnp.int32)

    k = slot - g_off
    if tight:
        g_masks = [
            g[:, 6 + r].astype(jnp.int32) for r in range(len(masks_p))
        ]
        tile = _decode_mask_tile(k, g_masks, span, tw, g_tx, g_ty)
    else:
        sx = jnp.maximum(g_sx, 1)
        ky = k // sx
        kx = k - ky * sx
        tile = (g_ty + ky) * tw + (g_tx + kx)
    tile_buf = jnp.where(in_range, tile, n_tiles)
    gid_buf = jnp.where(in_range, g_gid, -1)
    depth_buf = jnp.where(in_range, g_depth, jnp.inf)

    # One stable lexicographic sort on (tile, depth) — the torch
    # backend's two-pass argsort (binning.py:223-229) collapsed into a
    # single fused sort. (Emission is already depth-ordered, so the
    # depth key is redundant here; it stays as the oracle's independent
    # statement of the ordering contract.)
    sorted_tile, _, sorted_gid = jax.lax.sort(
        (tile_buf, depth_buf, gid_buf), num_keys=2, is_stable=True
    )

    # Per-tile [start, end) ranges via one searchsorted (binning.py:252-256).
    boundaries = jnp.searchsorted(
        sorted_tile, jnp.arange(n_tiles + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    tile_ranges = jnp.stack([boundaries[:-1], boundaries[1:]], axis=-1)
    tile_ranges = tile_ranges.reshape(th, tw, 2)

    num_isects = boundaries[-1]
    aux = BinningAux(
        num_isects=num_isects,
        capacity_overflow=jnp.maximum(total - capacity, 0).astype(jnp.int32),
        span_truncated=span_truncated.astype(jnp.int32),
        tight_culled=tight_culled.astype(jnp.int32),
    )
    return BinningResult(
        gaussian_ids=sorted_gid,
        tile_ids=sorted_tile,
        tile_ranges=tile_ranges,
        aux=aux,
    )
