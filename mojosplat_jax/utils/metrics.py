"""Observability: stage timing, recompile counting, structured logging.

The reference has no logging subsystem — fallbacks and warnings are bare
print() calls (/root/reference/mojosplat/binning.py:274, rasterization.py:74,
render.py:74,85) and its only timing is the external benchmark's
cuda.synchronize-fenced wall clock (examples/benchmark_proj.py:124-145).
SURVEY.md section 5 calls for structured logging plus a recompile counter
(load-bearing given the no-recompile design goal) — this module provides both.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import jax

logger = logging.getLogger("mojosplat_jax")


@dataclass
class StageTimer:
    """Wall-clock timing per pipeline stage, device-fenced.

    The JAX analogue of the reference benchmark's ``torch.cuda.synchronize()``
    fencing (benchmark_proj.py:131-141): each stage is timed to
    ``jax.block_until_ready`` on its outputs.
    """

    times: dict[str, list] = field(default_factory=dict)

    @contextmanager
    def stage(self, name: str, outputs_holder: list | None = None):
        t0 = time.perf_counter()
        yield
        if outputs_holder:
            jax.block_until_ready(outputs_holder)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, ts in self.times.items():
            out[name] = {
                "mean_ms": 1e3 * sum(ts) / len(ts),
                "min_ms": 1e3 * min(ts),
                "max_ms": 1e3 * max(ts),
                "count": len(ts),
            }
        return out


def amortized_ms(fn, args, iters: int = 20) -> float:
    """Per-iteration device time of ``fn(*args)`` in milliseconds.

    Runs ``iters`` iterations chained through a lax.scan carry inside ONE
    jitted call and subtracts a 1-iteration call, cancelling per-dispatch
    overhead (which dominates naive per-call timing of sub-millisecond
    stages). The first float leaf
    of args is perturbed by carry*0 each iteration so XLA cannot hoist the
    body out of the loop. ``fn`` must accept ``*args`` and return a pytree.
    """
    import functools

    import jax.numpy as jnp

    def one(a):
        out = fn(*a)
        return sum(
            jnp.sum(jnp.abs(x.astype(jnp.float32)))
            for x in jax.tree_util.tree_leaves(out)
        )

    def loop(a, n):
        def body(c, _):
            leaves, treedef = jax.tree_util.tree_flatten(a)
            bumped = False
            out = []
            for x in leaves:
                if not bumped and hasattr(x, "dtype") and jnp.issubdtype(
                    x.dtype, jnp.floating
                ):
                    out.append(x + c * 0.0)
                    bumped = True
                else:
                    out.append(x)
            return one(jax.tree_util.tree_unflatten(treedef, out)), None

        return jax.lax.scan(body, 0.0, None, length=n)[0]

    fN = jax.jit(functools.partial(loop, n=iters))
    f1 = jax.jit(functools.partial(loop, n=1))
    float(f1(args))
    float(fN(args))
    t0 = time.perf_counter()
    float(f1(args))
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    float(fN(args))
    tN = time.perf_counter() - t0
    return max(tN - t1, 0.0) / (iters - 1) * 1e3


def compilation_count(fn) -> int:
    """Number of compiled variants a jitted function holds — the recompile
    counter of SURVEY.md section 5. A scene change must not grow this."""
    return fn._cache_size()


def log_render_aux(aux, step: int | None = None) -> dict:
    """Structured per-render metric dict from RenderAux; logs overflow
    warnings (the reference silently prints-and-drops, binning.py:202-206)."""
    rec = {
        "num_isects": int(aux.binning.num_isects),
        "isect_capacity_overflow": int(aux.binning.capacity_overflow),
        "tile_span_truncated": int(aux.binning.span_truncated),
        "tile_capacity_overflow": int(aux.raster.tile_overflow),
    }
    if step is not None:
        rec["step"] = step
    if rec["isect_capacity_overflow"] or rec["tile_capacity_overflow"]:
        logger.warning("render overflow: %s", rec)
    else:
        logger.debug("render metrics: %s", rec)
    return rec
