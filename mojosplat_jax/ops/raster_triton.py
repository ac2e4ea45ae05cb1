"""Tiled 3DGS rasterization as Pallas kernels for the GPU (Triton route).

The design is gsplat's CUDA rasterizer (and the Mojo kernel of the reference,
kernels/rasterization.mojo:16-162): one program per block of a screen tile's
pixels, walking that tile's depth-sorted gaussians front to back, with

  1. **per-tile dynamic work**: the loop runs over the tile's real
     intersection count, not over the static ``tile_capacity`` the XLA route
     (rasterization.rasterize_xla_generic) blends for every tile;
  2. **early exit**: the block stops as soon as every one of its pixels has
     terminated (transmittance would fall to <= 1e-4), the same point at which
     a gsplat thread block leaves its loop.

Gaussians are consumed in chunks of ``_K``: each chunk is a (pixels, _K) tile
of alphas whose sequential front-to-back recurrence is a scan along the chunk
axis. Triton has no cumulative product, so the transmittance prefix is
``exp(cumsum(log1p(-alpha)))``; this reorders the rounding of the XLA route's
``cumprod`` (relative differences of a few float32 ulps per chunk).

The forward saves, per pixel, the final transmittance and the number of slots
it consumed (gsplat's ``last_ids``). The backward walks the same chunks back
to front from there, recovering each gaussian's incoming transmittance by
dividing the final one by the ``(1 - alpha)`` of everything behind it, as
gsplat's backward does. It writes one gradient row per slot; routing those
rows to gaussians is left to XLA (the adjoint of the gather that packed the
slot table, a scatter-add).

Pixel blocks hold at most ``_PB`` pixels: a 32x32 tile runs as four programs,
each of which writes its own partial per-slot gradient rows; the four are
summed in XLA, so the backward is deterministic up to that scatter-add.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Gaussians per chunk (the scan axis) and pixels per program. A (256, 16)
# float32 tile is 32 registers per thread at 4 warps, which leaves room for
# the dozen such temporaries the backward keeps live.
_K = 16
_PB = 256
_NUM_WARPS = 4
_GEOM_ROWS = 6  # x, y, conic a, b, c, opacity; colour channels follow


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def pixel_blocking(tile_size: int) -> tuple[int, int]:
    """(pixels per program, programs per tile) for a square tile."""
    pb = min(_PB, _pow2_at_least(tile_size * tile_size))
    return pb, -(-(tile_size * tile_size) // pb)


def _pixel_centres(t, s, ts, tw, pb):
    """Pixel index within the tile and pixel centres (+0.5, the reference's
    convention, rasterization.mojo:78-79) of block ``s`` of tile ``t``."""
    p = s * pb + jax.lax.broadcasted_iota(jnp.int32, (pb,), 0)
    tile_y = t // tw
    tile_x = t - tile_y * tw
    px = (tile_x * ts + p % ts).astype(jnp.float32) + 0.5
    py = (tile_y * ts + p // ts).astype(jnp.float32) + 0.5
    return p, px, py


def _chunk_alpha(pd_ref, start, count_left, px, py, config):
    """Fields and alphas of one chunk of slots [start, start + _K).

    Slots at or past the tile's count (``count_left`` <= j) get alpha 0.
    Matches rasterization._pixel_alphas.
    """
    sl = pl.ds(start, _K)
    x, y = pd_ref[0, sl], pd_ref[1, sl]
    ca, cb, cc = pd_ref[2, sl], pd_ref[3, sl], pd_ref[4, sl]
    op = pd_ref[5, sl]
    dx = x[None, :] - px[:, None]  # (PB, K)
    dy = y[None, :] - py[:, None]
    sigma = (0.5 * (ca[None, :] * dx * dx + cc[None, :] * dy * dy)
             + cb[None, :] * dx * dy)
    e = jnp.exp(-sigma)
    raw = op[None, :] * e
    alpha = jnp.minimum(raw, config.max_alpha)
    j = jax.lax.broadcasted_iota(jnp.int32, (1, _K), 1)
    keep = (sigma >= 0.0) & (alpha >= config.alpha_threshold) & (j < count_left)
    alpha = jnp.where(keep, alpha, 0.0)
    return alpha, raw, e, dx, dy, (ca, cb, cc)


def _fwd_kernel(counts_ref, pd_ref, acc_ref, tfin_ref, ncon_ref, *,
                ts, tw, cap, n_ch, pb, config):
    t = pl.program_id(0)
    s = pl.program_id(1)
    eps = config.transmittance_eps
    count = counts_ref[t]
    p, px, py = _pixel_centres(t, s, ts, tw, pb)
    n_chunks = (count + _K - 1) // _K
    base = t * cap

    def cond(carry):
        k, alive = carry[0], carry[1]
        return (k < n_chunks) & (alive > 0)

    def body(carry):
        k, _, T, done, ncon, *acc = carry
        alpha, *_ = _chunk_alpha(pd_ref, base + k * _K, count - k * _K,
                                 px, py, config)
        log_om = jnp.log1p(-alpha)
        cum = jnp.cumsum(log_om, axis=1)
        t_after = T[:, None] * jnp.exp(cum)
        # t_after is non-increasing along the chunk, so `applied` is a
        # prefix: the sequential break at T <= eps (rasterization.mojo:147).
        applied = (t_after > eps) & (done[:, None] == 0)
        w = jnp.where(applied, alpha * T[:, None] * jnp.exp(cum - log_om), 0.0)
        cols = [pd_ref[_GEOM_ROWS + c, pl.ds(base + k * _K, _K)]
                for c in range(n_ch)]
        acc = [a + jnp.sum(w * col[None, :], axis=1)
               for a, col in zip(acc, cols)]
        n_app = jnp.sum(applied.astype(jnp.int32), axis=1)
        ncon = jnp.where(n_app > 0, k * _K + n_app, ncon)
        T = T * jnp.exp(jnp.sum(jnp.where(applied, log_om, 0.0), axis=1))
        # A live pixel that stopped short of the chunk's end has terminated.
        done = jnp.where(n_app < _K, 1, done)
        alive = jnp.max(1 - done)
        return (k + 1, alive, T, done, ncon, *acc)

    done0 = jnp.where(p < ts * ts, 0, 1).astype(jnp.int32)
    init = (
        jnp.int32(0), jnp.max(1 - done0),
        jnp.ones((pb,), jnp.float32), done0, jnp.zeros((pb,), jnp.int32),
        *[jnp.zeros((pb,), jnp.float32) for _ in range(n_ch)],
    )
    _, _, T, _, ncon, *acc = jax.lax.while_loop(cond, body, init)
    px_sl = pl.ds(s * pb, pb)
    for c in range(n_ch):
        acc_ref[t, c, px_sl] = acc[c]
    tfin_ref[t, px_sl] = T
    ncon_ref[t, px_sl] = ncon


def _bwd_kernel(counts_ref, pd_ref, tfin_ref, ncon_ref, gacc_ref, gt_ref,
                _zeros_ref, dpd_ref, *, ts, tw, cap, n_ch, pb, config):
    t = pl.program_id(0)
    s = pl.program_id(1)
    count = counts_ref[t]
    _, px, py = _pixel_centres(t, s, ts, tw, pb)
    base = t * cap
    px_sl = pl.ds(s * pb, pb)
    tfin = tfin_ref[t, px_sl]
    ncon = ncon_ref[t, px_sl]
    v = [gacc_ref[t, c, px_sl] for c in range(n_ch)]
    # d tfin / d alpha_j = -tfin / (1 - alpha_j) for every applied j.
    g_tfin = gt_ref[t, px_sl] * tfin
    last_chunk = (jnp.max(ncon) + _K - 1) // _K
    j = jax.lax.broadcasted_iota(jnp.int32, (1, _K), 1)

    def body(i, carry):
        T_out, S = carry  # T after this chunk; sum of w * (v . colour) behind
        k = last_chunk - 1 - i
        start = base + k * _K
        alpha, raw, e, dx, dy, (ca, cb, cc) = _chunk_alpha(
            pd_ref, start, count - k * _K, px, py, config)
        applied = (alpha > 0.0) & (k * _K + j < ncon[:, None])
        eff = jnp.where(applied, alpha, 0.0)
        log_om = jnp.log1p(-eff)
        cum = jnp.cumsum(log_om, axis=1)
        tot = jnp.sum(log_om, axis=1)
        # Transmittance in front of each gaussian, recovered from T_out.
        t_before = T_out[:, None] * jnp.exp(cum - log_om - tot[:, None])
        w = eff * t_before
        cols = [pd_ref[_GEOM_ROWS + c, pl.ds(start, _K)] for c in range(n_ch)]
        cv = v[0][:, None] * cols[0][None, :]
        for c in range(1, n_ch):
            cv = cv + v[c][:, None] * cols[c][None, :]
        q = w * cv
        q_tot = jnp.sum(q, axis=1)
        behind = S[:, None] + q_tot[:, None] - jnp.cumsum(q, axis=1)
        d_alpha = cv * t_before - (behind + g_tfin[:, None]) / (1.0 - eff)
        d_raw = jnp.where(applied & (raw < config.max_alpha), d_alpha, 0.0)
        d_sigma = -d_raw * raw
        d_op = d_raw * e
        sdx = d_sigma * dx
        sdy = d_sigma * dy
        grads = [
            ca * jnp.sum(sdx, axis=0) + cb * jnp.sum(sdy, axis=0),
            cc * jnp.sum(sdy, axis=0) + cb * jnp.sum(sdx, axis=0),
            0.5 * jnp.sum(sdx * dx, axis=0),
            jnp.sum(sdx * dy, axis=0),
            0.5 * jnp.sum(sdy * dy, axis=0),
            jnp.sum(d_op, axis=0),
        ] + [jnp.sum(w * vc[:, None], axis=0) for vc in v]
        for f, g in enumerate(grads):
            dpd_ref[s, f, pl.ds(start, _K)] = g
        return T_out * jnp.exp(-tot), S + q_tot

    jax.lax.fori_loop(
        0, last_chunk, body, (tfin, jnp.zeros((pb,), jnp.float32)))


def _geometry(pdata, counts, ts):
    n_tiles = counts.shape[0]
    cap = pdata.shape[1] // n_tiles
    if cap % _K:
        raise ValueError(
            f"tile_capacity {cap} must be a multiple of {_K} for the Pallas "
            "rasterizer")
    pb, n_sub = pixel_blocking(ts)
    return n_tiles, cap, pdata.shape[0] - _GEOM_ROWS, pb, n_sub


def _call(kernel, out_shape, grid, config, **kw):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=grid,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=config.pallas_interpret,
        **kw,
    )


def _raster_fwd_call(pdata, counts, ts, tw, config):
    n_tiles, cap, n_ch, pb, n_sub = _geometry(pdata, counts, ts)
    kernel = functools.partial(_fwd_kernel, ts=ts, tw=tw, cap=cap, n_ch=n_ch,
                               pb=pb, config=config)
    f32 = jnp.float32
    return _call(
        kernel,
        [jax.ShapeDtypeStruct((n_tiles, n_ch, n_sub * pb), f32),
         jax.ShapeDtypeStruct((n_tiles, n_sub * pb), f32),
         jax.ShapeDtypeStruct((n_tiles, n_sub * pb), jnp.int32)],
        (n_tiles, n_sub), config,
    )(counts, pdata)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def raster_tiles(pdata, counts, ts, tw, config):
    """Blend each tile's slots front to back.

    Args:
        pdata: (6 + C, n_tiles * cap) float32 slot table, field-major: rows
            x, y, conic a, b, c, opacity, then C colour channels. Slot
            ``t * cap + j`` holds the j-th nearest gaussian of tile t; slots
            at or past ``counts[t]`` are never blended.
        counts: (n_tiles,) int32 slots in use per tile (<= cap).
        ts, tw: tile size and tile-grid width (static).
        config: RenderConfig (static).

    Returns:
        (acc (n_tiles, C, Ppad), tfin (n_tiles, Ppad)): premultiplied colour
        without background, and final transmittance, per pixel of each tile
        (pixel p = row * ts + col; entries p >= ts * ts are padding).
    """
    acc, tfin, _ = _raster_fwd_call(pdata, counts, ts, tw, config)
    return acc, tfin


def _raster_fwd_rule(pdata, counts, ts, tw, config):
    acc, tfin, ncon = _raster_fwd_call(pdata, counts, ts, tw, config)
    return (acc, tfin), (pdata, counts, tfin, ncon)


def _raster_bwd_rule(ts, tw, config, res, g):
    pdata, counts, tfin, ncon = res
    g_acc, g_tfin = g
    n_tiles, cap, n_ch, pb, n_sub = _geometry(pdata, counts, ts)
    kernel = functools.partial(_bwd_kernel, ts=ts, tw=tw, cap=cap, n_ch=n_ch,
                               pb=pb, config=config)
    shape = (n_sub,) + pdata.shape
    # Slots no pixel consumed are never written: they keep these zeros.
    zeros = jnp.zeros(shape, jnp.float32)
    d_parts = _call(
        kernel, jax.ShapeDtypeStruct(shape, jnp.float32), (n_tiles, n_sub),
        config, input_output_aliases={6: 0},
    )(counts, pdata, tfin, ncon, g_acc.astype(jnp.float32),
      g_tfin.astype(jnp.float32), zeros)
    d_pdata = d_parts[0] if n_sub == 1 else jnp.sum(d_parts, axis=0)
    return d_pdata, np.zeros(counts.shape, dtype=jax.dtypes.float0)


raster_tiles.defvjp(_raster_fwd_rule, _raster_bwd_rule)
