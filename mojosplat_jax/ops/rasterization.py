"""Tiled, depth-ordered alpha-compositing rasterization (pure JAX).

A pure-XLA formulation of the reference's CUDA-style rasterizer
(kernels/rasterization.mojo:16-162). The reference assigns one GPU thread per
pixel, stages gaussians in shared memory between barriers, and lets each
thread break out of its loop independently (rasterization.mojo:147-149).
Here the sequential front-to-back recurrence

    for each gaussian g (depth order):
        alpha = min(opacity * exp(-sigma), 0.999)        # :143
        skip if sigma < 0 or alpha < 1/255               # :144
        next_T = T * (1 - alpha); stop if next_T <= 1e-4 # :147-149
        pix += color * alpha * T;  T = next_T            # :152-157
    pix += T * background                                # :160-162

is re-expressed as a *vectorized chunk recurrence*: within a chunk of K
gaussians the per-gaussian weights are ``alpha_k * T_in * prod_{j<k}(1-alpha_j)``
(a cumulative product along the chunk axis), the early-termination test becomes
a monotone mask ``T_in * cumprod(1-alpha) > 1e-4`` (T is non-increasing, so the
mask is exactly the sequential break), and the color accumulation becomes a
(pixels x K) @ (K x channels) matmul. Chunks are chained with a lax.scan
carrying (T, done, accum) per pixel.

This formulation has two payoffs:
  1. It is a dense, static-shape dataflow program that XLA compiles as is.
  2. It is differentiable by plain ``jax.grad`` (cumprod, where, matmul), which
     supplies the backward pass the reference lacks entirely (render.py:11 is
     @torch.no_grad(); README.md:145 lists backward as future work) with
     deterministic scatter-add gradient accumulation, no atomics.

Two implementations share the math:
  - ``rasterize_gaussians``: the production tiled path consuming binning output
    via a dense (n_tiles, tile_capacity) index table.
  - ``rasterize_dense_oracle``: an O(H*W*N) oracle that sorts all gaussians
    globally and applies the tile-membership test analytically — no
    scatter/sort machinery shared with the production path, used by tests as
    the independent ground truth (the role gsplat plays for the reference,
    SURVEY.md section 4).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import DEFAULT_CONFIG, RenderConfig
from .binning import BinningResult, num_tiles


class RasterAux(NamedTuple):
    """Per-pixel final transmittance (the output the reference computes but
    discards, rasterization.py:124) plus observability counters."""

    final_transmittance: jax.Array  # (H, W)
    tile_overflow: jax.Array  # int32: intersections dropped by tile_capacity


def _blend_chunk(T_in, done_in, accum_in, alpha, colors_chunk, eps,
                 vals=None, accum_vals_in=None):
    """One chunk of the front-to-back recurrence, vectorized over pixels.

    Args:
        T_in: (P,) transmittance entering the chunk.
        done_in: (P,) bool, early-termination latch (rasterization.mojo:148-149
            sets ``done`` and skips all later batches).
        accum_in: (P, C) accumulated premultiplied color.
        alpha: (P, K) per-pixel alpha of each gaussian in the chunk, already
            zeroed for skipped gaussians (sigma<0 / alpha<1/255 / padding).
        colors_chunk: (K, C) gaussian colors.
        eps: early-termination transmittance threshold (1e-4).
        vals: optional (P, K, V) PER-PIXEL values to blend (e.g. a surfel's
            ray-intersection depth, which unlike a color varies per pixel);
            accumulated into accum_vals_in (P, V) with the same weights.

    Returns updated (T, done, accum[, accum_vals]).
    """
    one_minus = 1.0 - alpha
    # Inclusive running transmittance with the *original* alphas; because T is
    # non-increasing along the chunk, ``T_after > eps`` reproduces the
    # sequential break exactly (the gaussian that would drop T to <= eps is
    # itself not applied, rasterization.mojo:147-149).
    T_after = T_in[:, None] * jnp.cumprod(one_minus, axis=1)
    applied = (T_after > eps) & ~done_in[:, None]
    eff_alpha = jnp.where(applied, alpha, 0.0)

    one_minus_eff = 1.0 - eff_alpha
    # Exclusive cumulative product => transmittance *before* each gaussian.
    excl = jnp.concatenate(
        [jnp.ones_like(eff_alpha[:, :1]), jnp.cumprod(one_minus_eff, axis=1)[:, :-1]],
        axis=1,
    )
    T_before = T_in[:, None] * excl
    weights = eff_alpha * T_before  # (P, K)
    accum = accum_in + jnp.matmul(
        weights, colors_chunk, precision="highest"
    )  # (P,K)@(K,C); "highest" keeps it out of TF32 (gsplat parity)

    T_out = T_in * jnp.prod(one_minus_eff, axis=1)
    done_out = done_in | (T_after[:, -1] <= eps)
    if vals is None:
        return T_out, done_out, accum
    accum_vals = accum_vals_in + jnp.einsum(
        "pk,pkv->pv", weights, vals, precision="highest"
    )
    return T_out, done_out, accum, accum_vals


@jax.custom_vjp
def _abs_tap(means_k, sink_k):
    """Identity on ``means_k`` (``sink_k`` is all-zero by contract); its VJP
    duplicates the cotangent into ``sink_k`` with absolute value taken.

    Called once per (tile, slot): the surrounding gather's backward then
    scatter-adds |cotangent| over tiles into the (N, 2) sink — the AbsGS /
    gsplat absgrad statistic.
    """
    return means_k + sink_k


def _abs_tap_fwd(means_k, sink_k):
    return means_k + sink_k, None


def _abs_tap_bwd(_, ct):
    return ct, jnp.abs(ct)


_abs_tap.defvjp(_abs_tap_fwd, _abs_tap_bwd)


def _pixel_alphas(px, py, means_k, conics_k, opac_k, valid_k, config):
    """Alphas of K gaussians at P pixels. px/py: (P,), gaussian params: (K,...).

    Matches rasterization.mojo:138-144 (sigma formula, 0.999 cap, skip tests).
    """
    dx = means_k[None, :, 0] - px[:, None]  # (P, K)
    dy = means_k[None, :, 1] - py[:, None]
    a, b, c = conics_k[:, 0], conics_k[:, 1], conics_k[:, 2]
    sigma = 0.5 * (a[None, :] * dx * dx + c[None, :] * dy * dy) + b[None, :] * dx * dy
    alpha = jnp.minimum(opac_k[None, :] * jnp.exp(-sigma), config.max_alpha)
    keep = valid_k[None, :] & (sigma >= 0.0) & (alpha >= config.alpha_threshold)
    return jnp.where(keep, alpha, 0.0)


def build_tile_table(
    binning: BinningResult, tile_capacity: int
) -> tuple[jax.Array, jax.Array]:
    """Dense (n_tiles, tile_capacity) gaussian-id table from sorted lists.

    Entry e of the sorted intersection list lands at row ``tile_ids[e]``,
    column ``e - tile_start[tile_ids[e]]``. Padding/overflow slots are -1.
    Returns (table, overflow_count).
    """
    th, tw, _ = binning.tile_ranges.shape
    n_tiles = th * tw
    ranges_flat = binning.tile_ranges.reshape(n_tiles, 2)
    starts = ranges_flat[:, 0]
    counts = ranges_flat[:, 1] - ranges_flat[:, 0]

    M = binning.gaussian_ids.shape[0]
    t = binning.tile_ids  # (M,) padding entries have t == n_tiles
    e = jnp.arange(M, dtype=jnp.int32)
    rank = e - starts[jnp.clip(t, 0, n_tiles - 1)]
    ok = (t < n_tiles) & (rank >= 0) & (rank < tile_capacity)
    dest = jnp.where(ok, t * tile_capacity + rank, n_tiles * tile_capacity)

    table = jnp.full((n_tiles * tile_capacity,), -1, dtype=jnp.int32)
    table = table.at[dest].set(binning.gaussian_ids, mode="drop")
    overflow = jnp.sum(jnp.maximum(counts - tile_capacity, 0)).astype(jnp.int32)
    return table.reshape(n_tiles, tile_capacity), overflow


def rasterize_gaussians(
    means2d: jax.Array,  # (N, 2)
    conics: jax.Array,  # (N, 3)
    colors: jax.Array,  # (N, C)
    opacities: jax.Array,  # (N,)
    background: jax.Array,  # (C,)
    binning: BinningResult,
    img_height: int,
    img_width: int,
    config: RenderConfig = DEFAULT_CONFIG,
    absgrad_sink: jax.Array | None = None,
) -> tuple[jax.Array, RasterAux]:
    """Rasterize binned gaussians to an (H, W, C) image.

    Public role of rasterize_gaussians (/root/reference/mojosplat/
    rasterization.py:13-57); ``config.raster_impl`` picks the XLA route or
    the GPU kernels of raster_triton.py.

    ``absgrad_sink``: optional all-zero (N, 2) input whose cotangent is the
    per-gaussian absolute view-space gradient (AbsGS/gsplat absgrad
    densification statistic), taken per (tile, slot) by _abs_tap on both
    routes.
    """
    ts = config.tile_size
    th, tw = num_tiles(img_height, img_width, ts)
    n_tiles = th * tw
    dtype = colors.dtype

    if config.raster_impl == "pallas":
        from .raster_triton import raster_tiles

        # Slot j of tile t is sorted entry start_t + j: one gather off the
        # sorted list gives the (n_tiles, cap) slot table.
        cap = config.tile_capacity
        ranges_flat = binning.tile_ranges.reshape(n_tiles, 2)
        starts = ranges_flat[:, 0]
        raw_counts = ranges_flat[:, 1] - ranges_flat[:, 0]
        counts = jnp.clip(raw_counts, 0, cap).astype(jnp.int32)
        tile_overflow = jnp.sum(jnp.maximum(raw_counts - cap, 0)).astype(
            jnp.int32
        )
        ids = jax.lax.stop_gradient(binning.gaussian_ids)
        slot = starts[:, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
        gids = ids[jnp.minimum(slot, ids.shape[0] - 1).reshape(-1)]
        # Slots past a tile's count hold whatever follows it in the sorted
        # list (or -1 padding); the kernels never blend them.
        safe = jnp.clip(gids, 0, means2d.shape[0] - 1)
        packed = jnp.concatenate(
            [means2d, conics, opacities[:, None], colors], axis=1
        ).astype(jnp.float32)
        rows = packed[safe]  # (n_tiles * cap, 6 + C)
        if absgrad_sink is not None:
            rows = jnp.concatenate(
                [_abs_tap(rows[:, :2], absgrad_sink[safe]), rows[:, 2:]],
                axis=1,
            )
        acc, tfin = raster_tiles(rows.T, counts, ts, tw, config)
        P = ts * ts
        tfin = tfin[:, :P]
        out_tiles = (
            acc[:, :, :P] + tfin[:, None, :] * background[None, :, None]
        ).astype(dtype)

        def assemble_p(x):
            # (n_tiles, c, P) channel-major tiles -> (H, W, c)
            channels = x.shape[1]
            img = x.reshape(th, tw, channels, ts, ts)
            img = img.transpose(0, 3, 1, 4, 2)
            return img.reshape(th * ts, tw * ts, channels)[
                :img_height, :img_width
            ]

        image = assemble_p(out_tiles)
        final_T = assemble_p(tfin[:, None, :])[..., 0]
        return image, RasterAux(
            final_transmittance=final_T, tile_overflow=tile_overflow
        )
    if config.raster_impl != "xla":
        raise ValueError(f"Unknown raster_impl: {config.raster_impl!r}")

    def alpha_fn(px_t, py_t, safe, valid):
        means_k = means2d[safe]
        if absgrad_sink is not None:
            # Per-(tile, slot) tap: the sink gather's backward scatter-adds
            # |tile cotangent| per gaussian.
            means_k = _abs_tap(means_k, absgrad_sink[safe])
        return _pixel_alphas(
            px_t, py_t, means_k, conics[safe], opacities[safe],
            valid, config,
        )

    return rasterize_xla_generic(
        alpha_fn, means2d.shape[0], colors, background, binning,
        img_height, img_width, config,
    )


def rasterize_xla_generic(
    alpha_fn,
    n_gaussians: int,
    colors: jax.Array,  # (N, C)
    background: jax.Array,  # (C,)
    binning: BinningResult,
    img_height: int,
    img_width: int,
    config: RenderConfig = DEFAULT_CONFIG,
    n_pixel_values: int = 0,
) -> tuple[jax.Array, RasterAux]:
    """The XLA tiled blender with a pluggable per-primitive alpha model.

    ``alpha_fn(px (P,), py (P,), safe_ids (K,), valid (K,)) -> (P, K)``
    computes each primitive's alpha at each pixel (already zeroed for
    invalid/skipped entries). The 3DGS conic model (rasterize_gaussians)
    and the 2DGS surfel ray-intersection model (surfel.py) both plug in
    here, sharing the chunked front-to-back recurrence, early termination,
    background blend and aux outputs.

    With ``n_pixel_values = V > 0``, alpha_fn instead returns a tuple
    ``(alpha (P, K), vals (P, K, V))`` of PER-PIXEL per-primitive values
    (e.g. ray-intersection depths) blended with the same weights and
    appended to the image as V extra channels (zero background).
    """
    ts = config.tile_size
    K = config.chunk_size
    th, tw = num_tiles(img_height, img_width, ts)
    n_tiles = th * tw
    C = colors.shape[-1]
    dtype = colors.dtype

    table, tile_overflow = build_tile_table(binning, config.tile_capacity)
    table = jax.lax.stop_gradient(table)
    num_chunks = config.tile_capacity // K
    table_c = table.reshape(n_tiles, num_chunks, K)

    # Per-tile pixel centers at +0.5 (rasterization.mojo:78-79); pixel p is
    # (row, col) = divmod(p, ts) within the tile.
    tile_idx = jnp.arange(n_tiles, dtype=jnp.int32)
    tile_y, tile_x = tile_idx // tw, tile_idx % tw
    p = jnp.arange(ts * ts, dtype=jnp.int32)
    prow, pcol = p // ts, p % ts
    px = tile_x[:, None].astype(dtype) * ts + pcol[None, :].astype(dtype) + 0.5
    py = tile_y[:, None].astype(dtype) * ts + prow[None, :].astype(dtype) + 0.5

    P = ts * ts

    V = n_pixel_values

    def tile_fn(px_t, py_t, chunks_t):
        # px_t/py_t: (P,), chunks_t: (num_chunks, K)
        def step(carry, gids):
            T, done, accum, accum_v = carry
            safe = jnp.clip(gids, 0, n_gaussians - 1)
            valid = gids >= 0
            if V:
                alpha, vals = alpha_fn(px_t, py_t, safe, valid)
                T, done, accum, accum_v = _blend_chunk(
                    T, done, accum, alpha, colors[safe],
                    config.transmittance_eps, vals, accum_v,
                )
            else:
                alpha = alpha_fn(px_t, py_t, safe, valid)
                T, done, accum = _blend_chunk(
                    T, done, accum, alpha, colors[safe],
                    config.transmittance_eps,
                )
            return (T, done, accum, accum_v), None

        init = (
            jnp.ones((P,), dtype),
            jnp.zeros((P,), jnp.bool_),
            jnp.zeros((P, C), dtype),
            jnp.zeros((P, max(V, 1)), dtype),
        )
        step_fn = jax.checkpoint(step) if config.remat else step
        (T, _done, accum, accum_v), _ = jax.lax.scan(step_fn, init, chunks_t)
        out = accum + T[:, None] * background[None, :]
        if V:
            out = jnp.concatenate([out, accum_v], axis=-1)
        return out, T

    if config.tile_batch is None:
        out_tiles, T_tiles = jax.vmap(tile_fn)(px, py, table_c)
    else:
        # Scan over groups of tiles (vmap inside) to bound the working set;
        # differentiable (scan-of-vmap) and still one compiled program.
        out_tiles, T_tiles = jax.lax.map(
            lambda args: tile_fn(*args),
            (px, py, table_c),
            batch_size=min(config.tile_batch, n_tiles),
        )

    def assemble(x, channels):
        img = x.reshape(th, tw, ts, ts, channels)
        img = img.transpose(0, 2, 1, 3, 4)
        return img.reshape(th * ts, tw * ts, channels)[:img_height, :img_width]

    image = assemble(out_tiles, C + V)
    final_T = assemble(T_tiles[..., None], 1)[..., 0]
    return image, RasterAux(final_transmittance=final_T, tile_overflow=tile_overflow)


def rasterize_dense_oracle(
    means2d: jax.Array,  # (N, 2)
    conics: jax.Array,  # (N, 3)
    colors: jax.Array,  # (N, C)
    opacities: jax.Array,  # (N,)
    background: jax.Array,  # (C,)
    depths: jax.Array,  # (N,)
    radii: jax.Array,  # (N, 2) int32
    img_height: int,
    img_width: int,
    config: RenderConfig = DEFAULT_CONFIG,
) -> jax.Array:
    """O(H*W*N) oracle: global depth sort + analytic tile-membership test.

    Independent of the binning scatter/sort and the dense tile table, so it
    cross-validates both. Small scenes only (tests).
    """
    ts = config.tile_size
    th, tw = num_tiles(img_height, img_width, ts)
    N = means2d.shape[0]
    K = config.chunk_size
    dtype = colors.dtype
    C = colors.shape[-1]

    valid = (radii[:, 0] > 0) & (radii[:, 1] > 0)
    order = jnp.argsort(jnp.where(valid, depths, jnp.inf))
    means_s = means2d[order]
    conics_s = conics[order]
    colors_s = colors[order]
    opac_s = opacities[order]
    valid_s = valid[order]
    radii_s = radii[order].astype(dtype)

    # Same truncated tile bounds as binning (binning.py equivalent).
    x, y = means_s[:, 0], means_s[:, 1]
    tx_min = jnp.clip(jnp.floor((x - radii_s[:, 0]) / ts), 0, tw).astype(jnp.int32)
    tx_max = jnp.clip(jnp.ceil((x + radii_s[:, 0]) / ts), 0, tw).astype(jnp.int32)
    ty_min = jnp.clip(jnp.floor((y - radii_s[:, 1]) / ts), 0, th).astype(jnp.int32)
    ty_max = jnp.clip(jnp.ceil((y + radii_s[:, 1]) / ts), 0, th).astype(jnp.int32)
    span = config.max_tile_span
    ex_x = jnp.maximum(tx_max - tx_min - span, 0)
    ex_y = jnp.maximum(ty_max - ty_min - span, 0)
    tx_min = tx_min + ex_x // 2
    tx_max = jnp.minimum(tx_max - (ex_x - ex_x // 2), tx_min + span)
    ty_min = ty_min + ex_y // 2
    ty_max = jnp.minimum(ty_max - (ex_y - ex_y // 2), ty_min + span)

    # Pixel grid.
    yy = jnp.arange(img_height, dtype=dtype) + 0.5
    xx = jnp.arange(img_width, dtype=dtype) + 0.5
    px = jnp.tile(xx, img_height)  # (P,)
    py = jnp.repeat(yy, img_width)
    ptx = (px // ts).astype(jnp.int32)
    pty = (py // ts).astype(jnp.int32)
    P = img_height * img_width

    n_pad = -(-N // K) * K
    pad = n_pad - N

    def pad0(a):
        return jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    means_s, conics_s, colors_s, opac_s = map(
        pad0, (means_s, conics_s, colors_s, opac_s)
    )
    valid_s = jnp.pad(valid_s, (0, pad))
    tx_min, tx_max, ty_min, ty_max = map(pad0, (tx_min, tx_max, ty_min, ty_max))

    def step(carry, chunk):
        T, done, accum = carry
        m, cn, cl, op, vd, x0, x1, y0, y1 = chunk
        member = (
            (ptx[:, None] >= x0[None, :])
            & (ptx[:, None] < x1[None, :])
            & (pty[:, None] >= y0[None, :])
            & (pty[:, None] < y1[None, :])
        )  # (P, K)
        alpha = _pixel_alphas(px, py, m, cn, op, vd, config)
        alpha = jnp.where(member, alpha, 0.0)
        T, done, accum = _blend_chunk(
            T, done, accum, alpha, cl, config.transmittance_eps
        )
        return (T, done, accum), None

    chunks = (
        means_s.reshape(-1, K, 2),
        conics_s.reshape(-1, K, 3),
        colors_s.reshape(-1, K, C),
        opac_s.reshape(-1, K),
        valid_s.reshape(-1, K),
        tx_min.reshape(-1, K),
        tx_max.reshape(-1, K),
        ty_min.reshape(-1, K),
        ty_max.reshape(-1, K),
    )
    init = (
        jnp.ones((P,), dtype),
        jnp.zeros((P,), jnp.bool_),
        jnp.zeros((P, C), dtype),
    )
    (T, _done, accum), _ = jax.lax.scan(step, init, chunks)
    out = accum + T[:, None] * background[None, :]
    return out.reshape(img_height, img_width, C)
