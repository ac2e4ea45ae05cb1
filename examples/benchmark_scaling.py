"""Multi-device scaling benchmark: pixels/s vs device count over the mesh.

BASELINE config 5's measurement harness (sharded training-step render with
psum'd gradients; SURVEY.md section 7 build-order item 8's "scaling benchmark
at 1 chip / 1 host / N hosts"). The reference has no distributed code at all
(SURVEY.md section 2.3), so there is no reference analogue to cite beyond its
single-GPU benchmark CLI shape (examples/benchmark_proj.py:274-288).

Runs unchanged on:
  - the GPUs of one host (``python examples/benchmark_scaling.py``), where
    the mesh spans the cards and scaling efficiency is the headline;
  - a CPU host with XLA-faked devices for harness validation
    (``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
    python examples/benchmark_scaling.py --impl xla``) -- CPU timings do NOT
    model GPU scaling, the run just proves the sharded program compiles and
    executes at every mesh size.

Per device count D, the full training step (render + D-SSIM/L2 loss + psum'd
grads + optax update) is timed with in-jit scan amortization and reported as
pixels/s with efficiency relative to linear scaling from the smallest D.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mojosplat_jax import Camera, RenderConfig  # noqa: E402
from mojosplat_jax import train as mtrain  # noqa: E402
from mojosplat_jax.parallel import make_mesh  # noqa: E402
from mojosplat_jax.utils.metrics import amortized_ms  # noqa: E402
from mojosplat_jax.utils.runtime import enable_compile_cache  # noqa: E402


def scaling_point(
    n_devices: int,
    n_gaussians: int,
    H: int,
    W: int,
    sh_degree: int,
    config: RenderConfig,
    iters: int,
    pipeline: str = "dp-sp",
) -> dict:
    """Time one sharded train step on an n_devices mesh; return metrics.

    ``pipeline``:
      - "dp-sp": camera-DP x tile-row-SP, replicated params, psum'd grads
        (train.train_step_sharded over a ('data','tile') mesh).
      - "gauss": the fully gaussian-sharded all-to-all routed pipeline
        (parallel.train_step_gauss_sharded; params/grads/moments sharded,
        ZeRO-3) — BASELINE config 5's "tiles + gaussians sharded" point.
    """
    optimizer = mtrain.make_optimizer()

    if pipeline == "gauss":
        from mojosplat_jax.parallel import (
            make_gauss_mesh,
            train_step_gauss_sharded,
        )

        mesh = make_gauss_mesh(n_devices, jax.devices()[:n_devices])
        # One camera; height must split into whole tile-row slabs.
        Hg = (-(-H // (n_devices * config.tile_size))
              * n_devices * config.tile_size)
        params = mtrain.init_gaussians(
            jax.random.PRNGKey(0), n_gaussians, sh_degree=sh_degree
        )
        state = mtrain.init_train_state(params, optimizer)
        camera = Camera.create(
            R=jnp.eye(3), T=jnp.zeros(3), H=Hg, W=W,
            fx=0.5 * W, fy=0.5 * W, cx=W / 2, cy=Hg / 2,
        )
        target = jnp.zeros((Hg, W, 3), jnp.float32)

        def step(state, camera, target):
            new_state, loss = train_step_gauss_sharded(
                state, camera, target, optimizer, mesh,
                sh_degree=sh_degree, config=config,
            )
            return loss + 0.0 * sum(
                jnp.sum(v) for v in new_state.params.values()
            )

        ms = amortized_ms(step, (state, camera, target), iters=iters)
        return {
            "devices": n_devices,
            "mesh": {"gauss": n_devices},
            "pipeline": pipeline,
            "step_ms": ms,
            "pixels_per_s": Hg * W / (ms * 1e-3),
        }

    n_data = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_tile = n_devices // n_data
    mesh = make_mesh(n_data, n_tile, jax.devices()[:n_devices])

    params = mtrain.init_gaussians(
        jax.random.PRNGKey(0), n_gaussians, sh_degree=sh_degree
    )
    state = mtrain.init_train_state(params, optimizer)

    B = n_data  # one camera per data row
    cameras = Camera.create(
        R=jnp.broadcast_to(jnp.eye(3), (B, 3, 3)),
        T=jnp.zeros((B, 3)),
        H=H, W=W,
        fx=jnp.full(B, 0.5 * W), fy=jnp.full(B, 0.5 * W),
        cx=jnp.full(B, W / 2), cy=jnp.full(B, H / 2),
        near=jnp.full(B, 0.1), far=jnp.full(B, 100.0),
    )
    targets = jnp.zeros((B, H, W, 3), jnp.float32)

    def step(state, cameras, targets):
        new_state, loss = mtrain.train_step_sharded(
            state, cameras, targets, optimizer, mesh,
            sh_degree=sh_degree, config=config,
        )
        # Reduce to one scalar so the scan carry stays tiny.
        return loss + 0.0 * sum(
            jnp.sum(v) for v in new_state.params.values()
        )

    ms = amortized_ms(step, (state, cameras, targets), iters=iters)
    pixels = B * H * W
    return {
        "devices": n_devices,
        "mesh": {"data": n_data, "tile": n_tile},
        "pipeline": pipeline,
        "step_ms": ms,
        "pixels_per_s": pixels / (ms * 1e-3),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gaussians", type=int, default=100_000)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--sh-degree", type=int, default=0)
    ap.add_argument("--iterations", type=int, default=5)
    ap.add_argument("--impl", default="pallas", choices=["xla", "pallas"])
    ap.add_argument(
        "--devices", type=int, nargs="*", default=None,
        help="device counts to sweep (default: 1,2,4,... up to available)",
    )
    ap.add_argument(
        "--pipeline", default="dp-sp", choices=["dp-sp", "gauss", "both"],
        help="'dp-sp' = camera-DP x tile-SP with replicated params; "
        "'gauss' = the fully gaussian-sharded all-to-all routed pipeline "
        "(params/grads/moments sharded, ZeRO-3)",
    )
    ap.add_argument(
        "--multihost", action="store_true",
        help="initialize jax.distributed first (multi-process run): every "
        "process must launch this CLI; jax.devices() then spans all hosts "
        "and the mesh helpers build cross-host meshes. Configure "
        "explicitly with MOJOSPLAT_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID.",
    )
    args = ap.parse_args()
    enable_compile_cache()

    from mojosplat_jax.parallel import init_multihost, is_primary

    # Must run before the backend initializes; a plain single-host run with
    # no env configured is a no-op.
    init_multihost(require=args.multihost)
    if not is_primary():
        # Workers participate in every collective but only the primary
        # prints the report.
        import builtins

        builtins.print = lambda *a, **k: None

    avail = len(jax.devices())
    counts = args.devices or [d for d in (1, 2, 4, 8, 16, 32) if d <= avail]
    config = RenderConfig(
        raster_impl=args.impl,
    )

    print(f"backend={jax.default_backend()} devices_available={avail}")
    pipelines = (["dp-sp", "gauss"] if args.pipeline == "both"
                 else [args.pipeline])
    results = []
    by_pipe = {p: [] for p in pipelines}
    for d in counts:
        for pipe in pipelines:
            if pipe == "gauss" and args.gaussians % d != 0:
                print(f"skipping d={d}: gaussians not divisible by device "
                      "count (sharded leading axis)")
                continue
            r = scaling_point(
                d, args.gaussians, args.height, args.width,
                args.sh_degree, config, args.iterations,
                pipeline=pipe,
            )
            results.append(r)
            by_pipe[pipe].append(r)
            print(json.dumps(r))

    if args.pipeline == "both":
        # Routing overhead: the gaussian-sharded pipeline's cost over the
        # replicated dp-sp step at equal device count. At mesh=1 this is
        # the pure price of the routed formulation (windowed emission +
        # degenerate all_to_all + receiver merge) with zero communication
        # benefit — the number VERDICT r4 asked to be recorded.
        dp = {r["devices"]: r for r in by_pipe["dp-sp"]}
        for r in by_pipe["gauss"]:
            d = r["devices"]
            if d in dp:
                # px/s-normalized (the two pipelines render different
                # pixel counts per step, so raw step times don't compare).
                rel = r["pixels_per_s"] / max(dp[d]["pixels_per_s"], 1e-9)
                print(f"routed-vs-replicated @ {d} device(s): "
                      f"{r['pixels_per_s'] / 1e6:.2f} vs "
                      f"{dp[d]['pixels_per_s'] / 1e6:.2f} Mpix/s "
                      f"({rel:.1%} of replicated)")

    if len(results) > 1:
        base = results[0]
        print(f"\n{'devices':>8} {'step_ms':>10} {'Mpix/s':>10} "
              f"{'efficiency':>11}")
        for r in results:
            lin = base["pixels_per_s"] * r["devices"] / base["devices"]
            eff = r["pixels_per_s"] / lin
            print(f"{r['devices']:>8} {r['step_ms']:>10.2f} "
                  f"{r['pixels_per_s'] / 1e6:>10.2f} {eff:>10.1%}")


if __name__ == "__main__":
    main()
