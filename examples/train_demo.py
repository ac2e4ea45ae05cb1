"""End-to-end training demo: fit a gaussian cloud to rendered target views.

The reference is forward-only (@torch.no_grad(), /root/reference/mojosplat/
render.py:11; backward listed as future work, README.md:145) — this demo
exercises the full differentiable pipeline: a ground-truth scene renders B
target views, a fresh random cloud is optimized with Adam through the
renderer (Pallas kernels on the GPU, XLA route anywhere), and the fitted scene is
exported as a standard 3DGS PLY plus before/after PNGs.

    python examples/train_demo.py --steps 300 --impl pallas
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mojosplat_jax import Camera, RenderConfig, look_at, render_gaussians
from mojosplat_jax import train as mtrain
from mojosplat_jax.train import psnr
from mojosplat_jax.utils import save_gaussian_ply, save_png
from mojosplat_jax.utils.runtime import enable_compile_cache


def make_cameras(B, H, W):
    """B cameras on a ring looking at the origin."""
    Rs, Ts = [], []
    for i in range(B):
        ang = 2.0 * jnp.pi * i / B
        eye = jnp.array(
            [4.0 * jnp.sin(ang), 1.0, 4.0 * jnp.cos(ang)]
        )
        R, T = look_at(eye=eye, target=jnp.zeros(3), up=jnp.array([0.0, 1.0, 0.0]))
        Rs.append(R)
        Ts.append(T)
    f = 0.7 * W
    return Camera.create(
        R=jnp.stack(Rs), T=jnp.stack(Ts), H=H, W=W,
        fx=jnp.full((B,), f), fy=jnp.full((B,), f),
        cx=jnp.full((B,), W / 2), cy=jnp.full((B,), H / 2),
        near=jnp.full((B,), 0.1), far=jnp.full((B,), 100.0),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt-gaussians", type=int, default=4000)
    ap.add_argument("--fit-gaussians", type=int, default=4000)
    ap.add_argument("--views", type=int, default=6)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--impl", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--out-dir", default="output/train_demo")
    ap.add_argument("--steps-per-call", type=int, default=25)
    ap.add_argument(
        "--densify-every", type=int, default=0,
        help="run adaptive density control every N steps (0 = off); starts "
        "from fit-gaussians live slots padded to 2x capacity",
    )
    ap.add_argument(
        "--densify-grad-threshold", type=float, default=2e-6,
        help="mean view-space gradient norm above which a gaussian is "
        "cloned/split (the INRIA 2e-4 default assumes their loss scale; "
        "this demo's plain L2 on small images runs ~100x lower)",
    )
    ap.add_argument(
        "--strategy", default="adc", choices=["adc", "mcmc"],
        help="density-control family when --densify-every > 0: 'adc' = "
        "INRIA clone/split/prune; 'mcmc' = 3DGS-MCMC relocation + "
        "opacity-gated position noise + L1 regularizers",
    )
    args = ap.parse_args()
    enable_compile_cache()
    os.makedirs(args.out_dir, exist_ok=True)

    config = RenderConfig(
        tile_capacity=256, chunk_size=64, max_tile_span=8,
        raster_impl=args.impl,
    )
    H, W, B = args.height, args.width, args.views
    cams = make_cameras(B, H, W)

    # Ground-truth scene and target views.
    gt = mtrain.activate(
        mtrain.init_gaussians(
            jax.random.PRNGKey(0), args.gt_gaussians, position_scale=1.2,
            log_scale_mean=-2.6,
        )
    )

    def render_batch(p, cs):
        def one(cam):
            return render_gaussians(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, config=config,
            )

        return jax.vmap(one)(cs)

    targets = jax.jit(render_batch)(gt, cams)
    jax.block_until_ready(targets)
    print(f"Rendered {B} target views at {W}x{H}")

    # Fresh cloud to optimize.
    raw = mtrain.init_gaussians(
        jax.random.PRNGKey(42), args.fit_gaussians, position_scale=1.2,
        log_scale_mean=-2.6,
    )
    densify = args.densify_every > 0
    adc = densify and args.strategy == "adc"
    mcmc = densify and args.strategy == "mcmc"
    if densify:
        from mojosplat_jax.densify import (
            DensifyState,
            densify_and_prune,
            pad_to_capacity,
        )

        raw = pad_to_capacity(raw, 2 * args.fit_gaussians)
    optimizer = mtrain.make_optimizer(args.lr)
    state = mtrain.init_train_state(raw, optimizer)
    n_slots = raw["opacities_raw"].shape[0]

    if mcmc:
        from mojosplat_jax.densify import (
            MCMCConfig,
            mcmc_position_noise,
            mcmc_regularization,
            mcmc_relocate,
        )

        mcfg = MCMCConfig()
        step_fn_m = functools.partial(
            mtrain.train_step, optimizer=optimizer, config=config,
            loss_extra=lambda p: mcmc_regularization(p, mcfg),
        )

        def multi_step_m(state, key, cs, tgts, n):
            def body(carry, _):
                s, k = carry
                s, loss = step_fn_m(s, cs, tgts)
                k, sub = jax.random.split(k)
                noisy = mcmc_position_noise(s.params, sub, args.lr, mcfg)
                return (mtrain.TrainState(noisy, s.opt_state, s.step), k), loss

            (state, key), losses = jax.lax.scan(
                body, (state, key), None, length=n
            )
            return state, key, losses

        run_m = jax.jit(functools.partial(multi_step_m, n=args.steps_per_call))
        relocate_fn = jax.jit(functools.partial(mcmc_relocate, config=mcfg))
    elif adc:
        dstate = DensifyState.zero(n_slots)

        def multi_step(state, dstate, cs, tgts, n):
            def body(carry, _):
                s, d = carry
                s, d, loss = mtrain.train_step_with_densify_stats(
                    s, d, cs, tgts, optimizer, config=config
                )
                return (s, d), loss

            (state, dstate), losses = jax.lax.scan(
                body, (state, dstate), None, length=n
            )
            return state, dstate, losses

        run_d = jax.jit(functools.partial(multi_step, n=args.steps_per_call))
        from mojosplat_jax.densify import DensifyConfig

        densify_fn = jax.jit(
            functools.partial(
                densify_and_prune, scene_extent=3.0,
                config=DensifyConfig(
                    grad_threshold=args.densify_grad_threshold
                ),
            )
        )
    else:
        step_fn = functools.partial(
            mtrain.train_step, optimizer=optimizer, config=config
        )

        def multi_step(state, cs, tgts, n):
            def body(s, _):
                s, loss = step_fn(s, cs, tgts)
                return s, loss

            return jax.lax.scan(body, state, None, length=n)

        run = jax.jit(functools.partial(multi_step, n=args.steps_per_call))

    img0 = jax.jit(render_batch)(mtrain.activate(state.params), cams)
    print(f"initial PSNR: {float(psnr(img0, targets)):.2f} dB")
    save_png(img0[0], os.path.join(args.out_dir, "before.png"))
    save_png(targets[0], os.path.join(args.out_dir, "target.png"))

    t0 = time.perf_counter()
    done = 0
    key = jax.random.PRNGKey(7)
    while done < args.steps:
        if mcmc:
            state, key, losses = run_m(state, key, cams, targets)
        elif adc:
            state, dstate, losses = run_d(state, dstate, cams, targets)
        else:
            state, losses = run(state, cams, targets)
        done += args.steps_per_call
        msg = (
            f"step {done:5d}  loss {float(losses[-1]):.6f}  "
            f"({(time.perf_counter() - t0) / done * 1000:.1f} ms/step avg)"
        )
        if adc and done % args.densify_every == 0 and done < args.steps:
            key, sub = jax.random.split(key)
            params, dstate, metrics = densify_fn(state.params, dstate, sub)
            # Fresh optimizer state for the mutated parameter set.
            state = mtrain.TrainState(
                params, optimizer.init(params), state.step
            )
            msg += (
                f"  [densify: +{int(metrics['cloned'])} cloned, "
                f"+{int(metrics['split'])} split, "
                f"-{int(metrics['pruned'])} pruned, "
                f"{int(metrics['alive'])} alive]"
            )
        if mcmc and done % args.densify_every == 0 and done < args.steps:
            key, sub = jax.random.split(key)
            params, metrics = relocate_fn(state.params, sub)
            state = mtrain.TrainState(
                params, optimizer.init(params), state.step
            )
            msg += (
                f"  [mcmc: {int(metrics['relocated'])} relocated, "
                f"{int(metrics['alive'])} alive]"
            )
        print(msg)

    imgN = jax.jit(render_batch)(mtrain.activate(state.params), cams)
    final_psnr = float(psnr(imgN, targets))
    print(f"final PSNR: {final_psnr:.2f} dB after {done} steps")
    save_png(imgN[0], os.path.join(args.out_dir, "after.png"))

    ply_path = os.path.join(args.out_dir, "fitted.ply")
    save_gaussian_ply(
        ply_path, {k: jax.device_get(v) for k, v in state.params.items()}
    )
    print(f"Saved fitted scene to {ply_path}")
    return final_psnr


if __name__ == "__main__":
    main()
