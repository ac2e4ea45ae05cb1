"""End-to-end 2DGS (surfel) training demo.

Fits a cloud of 2D gaussian surfels to rendered target views with a
photometric loss plus the 2DGS paper's normal-consistency regularizer —
the second primitive family's analogue of train_demo.py. Runs on the CPU or
one GPU (XLA rasterization route).

    python examples/train_surfel_demo.py --steps 200
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import time

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mojosplat_jax import Camera, RenderConfig, look_at  # noqa: E402
from mojosplat_jax import train as mtrain  # noqa: E402
from mojosplat_jax.train import psnr  # noqa: E402
from mojosplat_jax.surfel import (  # noqa: E402
    normal_consistency_loss,
    render_surfels,
)
from mojosplat_jax.utils import save_gaussian_ply, save_png  # noqa: E402
from mojosplat_jax.utils.runtime import enable_compile_cache  # noqa: E402


def init_surfels(key, n, position_scale=1.0):
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    quats = jax.random.normal(k3, (n, 4))
    quats /= jnp.linalg.norm(quats, axis=-1, keepdims=True)
    return dict(
        means3d=jax.random.normal(k1, (n, 3)) * position_scale,
        scales=-2.3 + jax.random.normal(k2, (n, 2)) * 0.3,  # (N, 2): a disk
        quats=quats,
        opacities_raw=jax.random.normal(k4, (n,)) + 1.0,
        features=jax.random.uniform(k5, (n, 3)),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gt-surfels", type=int, default=2000)
    ap.add_argument("--fit-surfels", type=int, default=2000)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--normal-weight", type=float, default=0.01)
    ap.add_argument("--distortion-weight", type=float, default=0.001,
                    help="2DGS depth-distortion regularizer weight")
    ap.add_argument("--steps-per-call", type=int, default=25)
    ap.add_argument("--out-dir", default="output/train_surfel_demo")
    args = ap.parse_args()
    enable_compile_cache()
    os.makedirs(args.out_dir, exist_ok=True)

    H, W = args.height, args.width
    config = RenderConfig(tile_capacity=256, chunk_size=32)

    def make_cam(i):
        angle = 2.0 * 3.14159 * i / args.views
        eye = jnp.array(
            [3.0 * jnp.sin(angle), 0.8, 3.0 * jnp.cos(angle)]
        )
        R, T = look_at(eye=eye, target=jnp.zeros(3),
                       up=jnp.array([0.0, 1.0, 0.0]))
        return Camera.create(R=R, T=T, H=H, W=W, fx=0.9 * W, fy=0.9 * W,
                             cx=W / 2, cy=H / 2)

    cams = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[make_cam(i) for i in range(args.views)]
    )

    gt = mtrain.activate(
        init_surfels(jax.random.PRNGKey(1), args.gt_surfels, 0.8)
    )

    @jax.jit
    def render_batch(p, cs):
        def one(cam):
            return render_surfels(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, config=config,
            )

        return jax.vmap(one)(cs)

    targets = render_batch(gt, cams)
    jax.block_until_ready(targets)
    print(f"Rendered {args.views} target views at {W}x{H}")

    raw = init_surfels(jax.random.PRNGKey(42), args.fit_surfels, 1.0)
    optimizer = mtrain.make_optimizer(args.lr)
    state = mtrain.init_train_state(raw, optimizer)

    def step(st, cs, tgts):
        def loss_fn(params):
            p = mtrain.activate(params)

            def one(cam, tgt):
                img, depth, normal, dist, aux = render_surfels(
                    p["means3d"], p["scales"], p["quats"], p["opacities"],
                    p["features"], cam, config=config, return_aux=True,
                    return_depth=True, return_normals=True,
                    return_distortion=True,
                )
                photo = jnp.mean((img - tgt) ** 2)
                reg = normal_consistency_loss(
                    depth, normal, aux.raster.final_transmittance, cam
                )
                return (photo + args.normal_weight * reg
                        + args.distortion_weight * jnp.mean(dist))

            return jnp.mean(jax.vmap(one)(cs, tgts))

        loss, grads = jax.value_and_grad(loss_fn)(st.params)
        updates, opt_state = optimizer.update(grads, st.opt_state, st.params)
        params = optax.apply_updates(st.params, updates)
        return mtrain.TrainState(params, opt_state, st.step + 1), loss

    def multi(st, cs, tgts, n):
        def body(s, _):
            s, loss = step(s, cs, tgts)
            return s, loss

        return jax.lax.scan(body, st, None, length=n)

    run = jax.jit(functools.partial(multi, n=args.steps_per_call))

    img0 = render_batch(mtrain.activate(state.params), cams)
    print(f"initial PSNR: {float(psnr(img0, targets)):.2f} dB")

    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        state, losses = run(state, cams, targets)
        done += args.steps_per_call
        print(f"step {done:5d}  loss {float(losses[-1]):.6f}  "
              f"({(time.perf_counter() - t0) / done * 1000:.1f} ms/step avg)")

    img1 = render_batch(mtrain.activate(state.params), cams)
    print(f"final PSNR: {float(psnr(img1, targets)):.2f} dB "
          f"after {done} steps")
    save_png(img1[0], os.path.join(args.out_dir, "after.png"))
    save_png(targets[0], os.path.join(args.out_dir, "target.png"))
    ply = os.path.join(args.out_dir, "fitted_surfels.ply")
    save_gaussian_ply(ply, jax.device_get(state.params))
    print(f"Saved fitted surfel scene to {ply} (2DGS two-scale layout)")


if __name__ == "__main__":
    main()
