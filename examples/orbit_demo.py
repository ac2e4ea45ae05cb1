"""Turntable orbit demo: render a camera orbit of a scene to PNG frames.

Demonstrates recompile-free novel-view synthesis: the camera is a jit
argument (a pytree), so all N frames reuse ONE compiled executable — the
reference re-JITs on any shape change and keeps the camera baked into its
kernel specialization.

    python examples/orbit_demo.py --frames 24 --impl pallas
    python examples/orbit_demo.py --ply scene.ply
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mojosplat_jax import Camera, RenderConfig, look_at, render_gaussians
from mojosplat_jax import train as mtrain
from mojosplat_jax.utils import load_gaussian_ply, save_png
from mojosplat_jax.utils.runtime import enable_compile_cache


def orbit_camera(angle, radius, H, W, f):
    eye = jnp.array(
        [radius * jnp.sin(angle), 0.3 * radius, radius * jnp.cos(angle)]
    )
    R, T = look_at(eye=eye, target=jnp.zeros(3), up=jnp.array([0.0, 1.0, 0.0]))
    return Camera.create(R=R, T=T, H=H, W=W, fx=f, fy=f, cx=W / 2, cy=H / 2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--gaussians", type=int, default=20_000)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--radius", type=float, default=5.0)
    ap.add_argument("--impl", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--ply", default=None)
    ap.add_argument("--sh-degree", type=int, default=None)
    ap.add_argument("--out-dir", default="output/orbit")
    ap.add_argument("--gif", action="store_true",
                    help="also write an animated orbit.gif of the frames")
    args = ap.parse_args()
    enable_compile_cache()
    if args.gif:
        import PIL  # noqa: F401  fail fast, before minutes of rendering
    os.makedirs(args.out_dir, exist_ok=True)

    sh_degree = args.sh_degree
    if args.ply:
        raw = load_gaussian_ply(args.ply)
        p = mtrain.activate({k: jnp.asarray(v) for k, v in raw.items()})
        if sh_degree is None:
            sh_degree = int(round(p["features"].shape[1] ** 0.5)) - 1
    else:
        p = mtrain.activate(
            mtrain.init_gaussians(
                jax.random.PRNGKey(3), args.gaussians, position_scale=1.3,
                log_scale_mean=-2.4,
            )
        )

    config = RenderConfig(
        tile_batch=512, max_tile_span=32, tile_capacity=512,
        raster_impl=args.impl,
    )

    @jax.jit
    def render(params, cam):
        return render_gaussians(
            params["means3d"], params["scales"], params["quats"],
            params["opacities"], params["features"], cam,
            sh_degree=sh_degree,
            background_color=jnp.array([0.05, 0.05, 0.08]), config=config,
        )

    t_first = None
    frames = []
    t0 = time.perf_counter()
    for i in range(args.frames):
        cam = orbit_camera(
            2.0 * jnp.pi * i / args.frames, args.radius,
            args.height, args.width, 0.7 * args.width,
        )
        img = render(p, cam)
        save_png(img, os.path.join(args.out_dir, f"frame_{i:03d}.png"))
        if args.gif:
            frames.append(np.asarray(
                jnp.clip(img, 0.0, 1.0) * 255).astype("uint8"))
        if i == 0:
            t_first = time.perf_counter() - t0
    dt = time.perf_counter() - t0
    steady = (dt - t_first) / max(args.frames - 1, 1)
    print(
        f"{args.frames} frames at {args.width}x{args.height}: first frame "
        f"{t_first:.1f}s (compile + first host readback), then "
        f"{steady * 1e3:.0f} ms/frame ({1.0 / steady:.1f} fps incl. PNG IO; "
        f"one compiled executable for all views)"
    )
    if args.gif:
        from PIL import Image

        ims = [Image.fromarray(f) for f in frames]
        gif = os.path.join(args.out_dir, "orbit.gif")
        ims[0].save(gif, save_all=True, append_images=ims[1:],
                    duration=80, loop=0)
        print(f"wrote {gif}")


if __name__ == "__main__":
    main()
