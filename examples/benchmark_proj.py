"""Projection-stage benchmark across gaussian counts.

Mirrors the reference harness (/root/reference/examples/benchmark_proj.py):
argparse CLI over implementations and gaussian counts (:274-288), warmup
iterations excluded from timing, device-fenced timed loop
(jax.block_until_ready replacing torch.cuda.synchronize,
benchmark_proj.py:124-145), per-count results table (:206-229), optional
log-log matplotlib plot (:232-271) and speedup analysis (:306-326).

The reference's backend axis {torch, gsplat, mojo} maps to this build's
two projection implementations: ``ewa`` (the reference's fused EWA
linearization) and ``ut`` (the 3DGUT unscented transform through the exact
camera map — the contribution the reference's README lists as future
work). Both produce the same contract outputs, so the comparison is
apples-to-apples like the reference's.

Usage:
  python examples/benchmark_proj.py --impls ewa ut \
      --gaussians 1000 10000 100000 1000000
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mojosplat_jax import Camera, RenderConfig, look_at  # noqa: E402
from mojosplat_jax.ops.projection import project_gaussians  # noqa: E402
from mojosplat_jax.utils.runtime import enable_compile_cache  # noqa: E402


@dataclass
class BenchmarkResult:
    """(benchmark_proj.py:20-28)"""

    name: str
    n_gaussians: int
    mean_ms: float
    std_ms: float
    min_ms: float
    max_ms: float


def create_camera(height, width):
    R, T = look_at(
        jnp.array([0.0, 1.5, 5.0]), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0])
    )
    return Camera.create(
        R=R, T=T, H=height, W=width, fx=80.0, fy=80.0,
        cx=width / 2, cy=height / 2,
    )


def generate_gaussian_data(n, seed=42):
    # Same distributions as the reference (benchmark_proj.py:82-104).
    key = jax.random.PRNGKey(seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    means3d = jax.random.normal(k1, (n, 3)) * 2.0
    log_scales = -3.0 + jax.random.normal(k2, (n, 3)) * 0.1
    quats = jax.random.normal(k3, (n, 4))
    quats /= jnp.linalg.norm(quats, axis=-1, keepdims=True)
    opacities = jax.nn.sigmoid(jax.random.normal(k4, (n,)))
    return means3d, log_scales, quats, opacities


def benchmark_fn(name, fn, data, warmup, iters, n):
    # In-jit amortized timing: takes the per-call dispatch cost out of a
    # stage that runs in well under a millisecond.
    from mojosplat_jax.utils.metrics import amortized_ms

    del warmup  # amortized_ms warms both compiled variants itself
    reps = 3
    samples = [amortized_ms(fn, data, iters) for _ in range(reps)]
    mean = sum(samples) / reps
    std = (sum((t - mean) ** 2 for t in samples) / reps) ** 0.5
    return BenchmarkResult(name, n, mean, std, min(samples), max(samples))


def print_results_table(results):
    print(f"\n{'impl':<8} {'N':>10} {'mean ms':>10} {'std':>8} "
          f"{'min':>8} {'max':>8} {'gauss/s':>12}")
    print("-" * 70)
    for r in results:
        print(
            f"{r.name:<8} {r.n_gaussians:>10} {r.mean_ms:>10.3f} "
            f"{r.std_ms:>8.3f} {r.min_ms:>8.3f} {r.max_ms:>8.3f} "
            f"{r.n_gaussians / (max(r.mean_ms, 1e-3) / 1e3):>12.3e}"
        )


def plot_results(results, path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return
    names = sorted({r.name for r in results})
    plt.figure(figsize=(8, 6))
    for name in names:
        rs = sorted(
            [r for r in results if r.name == name], key=lambda r: r.n_gaussians
        )
        plt.loglog(
            [r.n_gaussians for r in rs], [r.mean_ms for r in rs],
            marker="o", label=name,
        )
    plt.xlabel("gaussians")
    plt.ylabel("mean latency (ms)")
    plt.title("Projection latency")
    plt.grid(True, which="both", alpha=0.3)
    plt.legend()
    plt.savefig(path, dpi=120)
    print(f"Plot saved to {path}")


def speedup_analysis(results):
    """Fastest/slowest implementation per N (benchmark_proj.py:306-326)."""
    by_n = {}
    for r in results:
        by_n.setdefault(r.n_gaussians, []).append(r)
    print("\nSpeedup analysis (per N, fastest vs slowest impl):")
    for n in sorted(by_n):
        rs = sorted(by_n[n], key=lambda r: r.mean_ms)
        if len(rs) < 2:
            continue
        fast, slow = rs[0], rs[-1]
        print(
            f"  N={n:>9}: {fast.name} {fast.mean_ms:.3f} ms vs "
            f"{slow.name} {slow.mean_ms:.3f} ms -> "
            f"{slow.mean_ms / max(fast.mean_ms, 1e-6):.2f}x"
        )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--impls", nargs="+", default=["ewa", "ut"],
        choices=["ewa", "ut"],
        help="projection implementations to compare (the reference's "
        "backend axis, benchmark_proj.py:274-288)",
    )
    ap.add_argument(
        "--gaussians", type=int, nargs="+",
        default=[1_000, 10_000, 100_000, 1_000_000],
    )
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--plot", default=None, help="output PNG path for plot")
    args = ap.parse_args()
    enable_compile_cache()

    camera = create_camera(args.height, args.width)

    results = []
    for n in args.gaussians:
        data = generate_gaussian_data(n) + (camera,)
        for impl in args.impls:
            cfg = RenderConfig(projection_mode=impl)

            def proj(m, s, q, o, cam, cfg=cfg):
                return project_gaussians(m, s, q, o, cam, cfg)

            results.append(
                benchmark_fn(impl, proj, data, args.warmup,
                             args.iterations, n)
            )
    print_results_table(results)

    # Throughput scaling analysis (reference speedup analysis analogue).
    per_impl = [r for r in results if r.name == args.impls[0]]
    if len(per_impl) >= 2:
        r0, r1 = per_impl[0], per_impl[-1]
        scale = (r1.n_gaussians / r0.n_gaussians) / (
            max(r1.mean_ms, 1e-3) / max(r0.mean_ms, 1e-3)
        )
        print(
            f"\nThroughput scaling {r0.n_gaussians} -> {r1.n_gaussians}: "
            f"{scale:.2f}x work per unit time (1.0 = linear cost)"
        )
    speedup_analysis(results)
    if args.plot:
        plot_results(results, args.plot)


if __name__ == "__main__":
    main()
