"""Full-pipeline benchmark: projection + binning + rasterization (+ backward).

This file exists in the reference's README (README.md:130 points users at
``examples/benchmark.py``) but NOT in its tree (SURVEY.md section 6) — we
provide it. Per-stage latencies are measured with device-fenced timers
(StageTimer), plus the fused jitted end-to-end forward and forward+backward.

Timing uses in-jit scan amortization (utils.metrics.amortized_ms), which
takes the per-call dispatch cost out of small stages' times.

Usage:
  python examples/benchmark.py --gaussians 100000 --height 608 --width 800
  python examples/benchmark.py --impls xla pallas --gaussians 10000 100000
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mojosplat_jax import Camera, RenderConfig, look_at, render_gaussians  # noqa: E402
from mojosplat_jax.ops.binning import bin_gaussians_to_tiles  # noqa: E402
from mojosplat_jax.ops.projection import project_gaussians  # noqa: E402
from mojosplat_jax.ops.rasterization import rasterize_gaussians  # noqa: E402
from mojosplat_jax.utils.metrics import amortized_ms  # noqa: E402
from mojosplat_jax.utils.runtime import enable_compile_cache  # noqa: E402
from benchmark_proj import create_camera, generate_gaussian_data  # noqa: E402


def run_pipeline(args, camera, impl, n):
    cfg = RenderConfig(
        tile_batch=args.tile_batch, raster_impl=impl,
    )
    m, s, q, o = generate_gaussian_data(n)
    colors = jax.random.uniform(jax.random.PRNGKey(1), (n, 3))

    # Precompute stage inputs once; cameras are jit ARGUMENTS, so a new
    # view never recompiles.
    proj = jax.jit(
        lambda m, s, q, o, cam: project_gaussians(m, s, q, o, cam, cfg)
    )(m, s, q, o, camera)
    binning = jax.jit(
        lambda m2, r, d: bin_gaussians_to_tiles(
            m2, r, d, camera.H, camera.W, cfg
        )
    )(proj.means2d, proj.radii, proj.depths)

    results = {}
    results["projection"] = amortized_ms(
        lambda m, s, q, o, cam: project_gaussians(m, s, q, o, cam, cfg),
        (m, s, q, o, camera), args.iterations,
    )
    results["binning"] = amortized_ms(
        lambda m2, r, d: bin_gaussians_to_tiles(
            m2, r, d, camera.H, camera.W, cfg
        ),
        (proj.means2d, proj.radii, proj.depths), args.iterations,
    )
    results["rasterization"] = amortized_ms(
        lambda m2, cn, c, o, b: rasterize_gaussians(
            m2, cn, c, o, jnp.zeros(3), b, camera.H, camera.W, cfg
        )[0],
        (proj.means2d, proj.conics, colors, o, binning), args.iterations,
    )

    def fwd(m, s, q, o, c, cam):
        return render_gaussians(
            m, s, q, o, c, cam,
            background_color=jnp.array([0.1, 0.1, 0.1]), config=cfg,
        )

    results["e2e_forward"] = amortized_ms(
        fwd, (m, s, q, o, colors, camera), args.iterations
    )
    results["e2e_fwd_bwd"] = amortized_ms(
        lambda m, s, q, o, c, cam: jax.grad(
            lambda mm: jnp.mean(fwd(mm, s, q, o, c, cam) ** 2)
        )(m),
        (m, s, q, o, colors, camera), args.iterations,
    )

    npix = args.height * args.width
    print(f"\nN={n}  {args.width}x{args.height}  impl={impl}  "
          f"isects={int(binning.aux.num_isects)}")
    print(f"{'stage':<16} {'ms/iter':>10} {'Mpix/s':>10}")
    print("-" * 40)
    for name, ms in results.items():
        # amortized_ms can floor at 0.0 for sub-resolution stages (tiny CPU
        # smoke shapes); keep the table printable.
        print(f"{name:<16} {ms:>10.3f} {npix / max(ms, 1e-3) / 1e3:>10.2f}")
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--gaussians", type=int, nargs="+", default=[100_000],
        help="gaussian counts to sweep",
    )
    ap.add_argument("--height", type=int, default=608)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--tile-batch", type=int, default=512)
    ap.add_argument(
        "--impls", nargs="+", default=["pallas"],
        choices=["xla", "pallas"],
        help="rasterizer implementations to compare side by side (the "
        "reference's per-stage backend axis, "
        "/root/reference/mojosplat/rasterization.py:41-57)",
    )
    args = ap.parse_args()
    enable_compile_cache()

    camera = create_camera(args.height, args.width)
    table = {}
    for n in args.gaussians:
        for impl in args.impls:
            table[(n, impl)] = run_pipeline(args, camera, impl, n)

    if len(args.impls) > 1 or len(args.gaussians) > 1:
        # Reference-style cross-implementation comparison table
        # (benchmark_proj.py:206-229 / speedup analysis :306-326), on the
        # axis that matters here: XLA oracle vs Pallas production raster.
        print(f"\n{'N':>10} {'impl':<8} {'fwd ms':>10} {'fwd+bwd ms':>12} "
              f"{'Mpix/s (fwdbwd)':>16}")
        print("-" * 62)
        npix = args.height * args.width
        for n in args.gaussians:
            for impl in args.impls:
                r = table[(n, impl)]
                fb = r["e2e_fwd_bwd"]
                print(f"{n:>10} {impl:<8} {r['e2e_forward']:>10.3f} "
                      f"{fb:>12.3f} {npix / max(fb, 1e-3) / 1e3:>16.2f}")
            if len(args.impls) > 1:
                ms = {i: table[(n, i)]["e2e_fwd_bwd"] for i in args.impls}
                fast = min(ms, key=ms.get)
                slow = max(ms, key=ms.get)
                if fast != slow:
                    print(f"{'':>10} -> {fast} is "
                          f"{ms[slow] / max(ms[fast], 1e-6):.2f}x faster "
                          f"than {slow}")


if __name__ == "__main__":
    main()
