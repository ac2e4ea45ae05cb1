"""Train a 3DGS scene on a NeRF-synthetic (Blender transforms.json) capture.

The synthetic-benchmark counterpart of train_colmap.py: no SfM points
exist, so gaussians initialize as a random cloud inside the camera rig's
working volume (the standard 3DGS recipe for these scenes), trained against
the white-composited RGBA renders with the D-SSIM + L1 loss, evaluated on
the held-out test split.

    python examples/train_blender.py --data /path/to/lego --steps 2000
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import optax

from mojosplat_jax import RenderConfig, render_gaussians
from mojosplat_jax import train as mtrain
from mojosplat_jax.utils import save_gaussian_ply, save_png
from mojosplat_jax.utils.blender import load_blender_scene
from mojosplat_jax.utils.runtime import enable_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True,
                    help="scene dir with transforms_{train,test}.json")
    ap.add_argument("--downscale", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--gaussians", type=int, default=65536)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ssim-weight", type=float, default=0.2)
    ap.add_argument("--impl", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--tile-capacity", type=int, default=512)
    ap.add_argument("--background", type=float, nargs=3,
                    default=(1.0, 1.0, 1.0))
    ap.add_argument("--out-dir", default="output/train_blender")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="held-out test-split PSNR every N steps")
    ap.add_argument("--strategy", default="none", choices=["none", "mcmc"],
                    help="'mcmc' = 3DGS-MCMC density control (relocation + "
                    "opacity-gated noise + L1 regularizers) at fixed "
                    "capacity — fills the random-init cloud with detail")
    ap.add_argument("--densify-every", type=int, default=100,
                    help="steps between MCMC relocation events")
    args = ap.parse_args()
    enable_compile_cache()
    os.makedirs(args.out_dir, exist_ok=True)

    scene = load_blender_scene(
        args.data, "train", background=args.background,
        downscale=args.downscale,
    )
    if scene.images is None or not len(scene.names):
        sys.exit("no training frames found")
    print(f"{len(scene.names)} train views at {scene.W}x{scene.H} "
          f"(fx {scene.fx:.1f})")
    targets = jnp.asarray(scene.images)
    bg = jnp.asarray(args.background, jnp.float32)

    # Init: random cloud inside the camera rig's working volume (cameras
    # orbit the object at a roughly constant radius; the object sits around
    # the origin within ~40% of that radius).
    cam_pos = np.stack([
        -scene.R[i].T @ scene.T[i] for i in range(len(scene.names))
    ])
    rig_radius = float(np.median(np.linalg.norm(cam_pos, axis=-1)))
    raw = mtrain.init_gaussians(
        jax.random.PRNGKey(0), args.gaussians, sh_degree=args.sh_degree,
        position_scale=0.4 * rig_radius / 2.0, log_scale_mean=-4.0,
    )

    config = RenderConfig(
        tile_capacity=args.tile_capacity, chunk_size=64, max_tile_span=8,
        tile_batch=512, raster_impl=args.impl,
    )
    optimizer = mtrain.make_optimizer(args.lr)
    state = mtrain.init_train_state(raw, optimizer)

    mcmc = args.strategy == "mcmc"
    if mcmc:
        from mojosplat_jax.densify import (
            MCMCConfig,
            mcmc_position_noise,
            mcmc_regularization,
            mcmc_relocate,
        )

        mcfg = MCMCConfig()
        relocate_fn = jax.jit(functools.partial(mcmc_relocate, config=mcfg))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step_fn(st, cam, target, key):
        def loss_fn(params):
            p = mtrain.activate(params)
            img = render_gaussians(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, sh_degree=args.sh_degree,
                background_color=bg, config=config,
            )
            loss = mtrain.dssim_l1_loss(
                img, target, ssim_weight=args.ssim_weight
            )
            if mcmc:
                loss = loss + mcmc_regularization(params, mcfg)
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(st.params)
        updates, opt_state = optimizer.update(grads, st.opt_state, st.params)
        params = optax.apply_updates(st.params, updates)
        if mcmc:
            params = mcmc_position_noise(params, key, args.lr, mcfg)
        return mtrain.TrainState(params, opt_state, st.step + 1), loss

    @jax.jit
    def render_view(params, cam):
        p = mtrain.activate(params)
        return render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, sh_degree=args.sh_degree,
            background_color=bg, config=config,
        )

    def eval_test():
        # Require a real transforms_test.json: the loader falls back to
        # transforms.json, which would silently score the TRAINING views
        # as "test PSNR".
        if not os.path.exists(
            os.path.join(args.data, "transforms_test.json")
        ):
            return None
        test = load_blender_scene(
            args.data, "test", background=args.background,
            downscale=args.downscale,
        )
        if test.images is None or not len(test.names):
            return None
        vals = []
        for i in range(len(test.names)):
            img = render_view(state.params, test.camera_for(i))
            vals.append(float(mtrain.psnr(img, jnp.asarray(test.images[i]))))
        return float(np.mean(vals)), len(vals)

    n_views = len(scene.names)
    rng = np.random.default_rng(0)
    base_key = jax.random.PRNGKey(23)
    t0 = time.perf_counter()
    losses = []
    for step in range(args.steps):
        i = int(rng.integers(n_views))
        state, loss = step_fn(state, scene.camera_for(i), targets[i],
                              jax.random.fold_in(base_key, step))
        losses.append(loss)
        if mcmc and (step + 1) % args.densify_every == 0 \
                and step + 1 < args.steps:
            params, metrics = relocate_fn(
                state.params,
                jax.random.fold_in(base_key, args.steps + step + 1),
            )
            state = mtrain.TrainState(
                params, optimizer.init(params), state.step
            )
            print(f"  [mcmc: {int(metrics['relocated'])} relocated, "
                  f"{int(metrics['alive'])} alive]", flush=True)
        if (step + 1) % 50 == 0:
            lv = float(jnp.mean(jnp.stack(losses[-50:])))
            dt = time.perf_counter() - t0
            print(f"step {step + 1:5d}  loss {lv:.5f}  "
                  f"{(step + 1) / dt:.2f} steps/s", flush=True)
        if args.eval_every and (step + 1) % args.eval_every == 0:
            ev = eval_test()
            if ev:
                print(f"  test PSNR {ev[0]:.2f} dB over {ev[1]} views",
                      flush=True)

    save_gaussian_ply(os.path.join(args.out_dir, "scene_final.ply"),
                      jax.device_get(state.params))
    img = np.asarray(render_view(state.params, scene.camera_for(0)))
    save_png(img, os.path.join(args.out_dir, "render_view0.png"))
    save_png(np.asarray(targets[0]),
             os.path.join(args.out_dir, "target_view0.png"))
    ev = eval_test()
    if ev:
        print(f"final test PSNR {ev[0]:.2f} dB over {ev[1]} views")
    print(f"Done: artifacts in {args.out_dir}")


if __name__ == "__main__":
    main()
