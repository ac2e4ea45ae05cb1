"""Demo: render a random gaussian cloud to a PNG.

Mirrors the reference demo workload (/root/reference/render_sample.py): 10k
random gaussians, 1920x1080, seed 42, camera at (0, 1.5, 5) looking at the
origin (gsplat axis convention), dark-gray background — but runs on any JAX
backend (the reference exits without CUDA, render_sample.py:44-46).

Usage: python render_sample.py [--gaussians 10000] [--out output/render_example.png]
"""

from __future__ import annotations

import argparse
import os
import time

import jax
import jax.numpy as jnp

from mojosplat_jax import Camera, RenderConfig, look_at, render_gaussians
from mojosplat_jax.utils import save_png
from mojosplat_jax.utils.runtime import enable_compile_cache


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gaussians", type=int, default=10_000)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default="output/render_example.png")
    ap.add_argument(
        "--impl", default="xla", choices=["xla", "pallas"],
        help="rasterizer route (pallas = the GPU kernels)",
    )
    ap.add_argument(
        "--ply", default=None,
        help="render a real 3DGS scene from a PLY file instead of the "
        "random demo cloud",
    )
    ap.add_argument("--sh-degree", type=int, default=None)
    ap.add_argument(
        "--depth", action="store_true",
        help="also save a normalized expected-depth map next to --out",
    )
    args = ap.parse_args()
    enable_compile_cache()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    # Camera: same pose/intrinsics as the reference demo
    # (render_sample.py:60-83): eye (0,1.5,5) -> origin, focal 500.
    R, T = look_at(
        eye=jnp.array([0.0, 1.5, 5.0]),
        target=jnp.zeros(3),
        up=jnp.array([0.0, 1.0, 0.0]),
    )
    camera = Camera.create(
        R=R, T=T, H=args.height, W=args.width,
        fx=500.0, fy=500.0, cx=args.width / 2, cy=args.height / 2,
        near=0.1, far=100.0,
    )

    sh_degree = args.sh_degree
    if args.ply is not None:
        from mojosplat_jax.utils import load_gaussian_ply

        print(f"Loading 3DGS scene from {args.ply}...")
        raw = load_gaussian_ply(args.ply)
        means3d = jnp.asarray(raw["means3d"])
        log_scales = jnp.asarray(raw["scales"])
        quats = jnp.asarray(raw["quats"])
        opacities = jax.nn.sigmoid(jnp.asarray(raw["opacities_raw"]))
        colors = jnp.asarray(raw["features"])  # (N, K, 3) SH
        if sh_degree is None:
            sh_degree = int(round(colors.shape[1] ** 0.5)) - 1
        print(f"  {means3d.shape[0]} gaussians, SH degree {sh_degree}")
    else:
        # Random scene, same distributions as the reference
        # (render_sample.py:86-109).
        key = jax.random.PRNGKey(args.seed)
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        n = args.gaussians
        print(f"Generating {n} random gaussians...")
        means3d = jax.random.normal(k1, (n, 3)) * 2.0
        log_scales = -2.0 + jax.random.normal(k2, (n, 3)) * 0.3
        quats = jax.random.normal(k3, (n, 4))
        quats /= jnp.linalg.norm(quats, axis=-1, keepdims=True)
        opacities = jax.nn.sigmoid(jax.random.normal(k4, (n,)) + 1.0)
        colors = jax.random.uniform(k5, (n, 3))

    # The random demo scene has near-camera gaussians spanning hundreds of
    # pixels; give them a generous tile-span budget (cheap at 10k gaussians —
    # binning memory is linear in the span). Production scenes use the default.
    config = RenderConfig(
        tile_batch=512, max_tile_span=64, tile_capacity=1024,
        raster_impl=args.impl,
    )
    # The camera is a jit argument, not a closure constant: a new view
    # never recompiles.
    render = jax.jit(
        lambda m, s, q, o, c, cam: render_gaussians(
            m, s, q, o, c, cam,
            sh_degree=sh_degree,
            background_color=jnp.array([0.1, 0.1, 0.1]),
            config=config,
            return_depth=args.depth,
            return_aux=args.depth,
        )
    )

    def unpack(out):
        return out if args.depth else (out, None, None)

    print("Rendering (compiling on first call)...")
    t0 = time.perf_counter()
    image, depth, aux = unpack(
        render(means3d, log_scales, quats, opacities, colors, camera)
    )
    image.block_until_ready()
    print(f"First render (incl. compile): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    image, depth, aux = unpack(
        render(means3d, log_scales, quats, opacities, colors, camera)
    )
    image.block_until_ready()
    print(f"Steady-state render: {time.perf_counter() - t0:.3f}s")
    print(f"Rendered image shape: {image.shape}")
    print(f"Rendered image range: [{float(image.min()):.4f}, "
          f"{float(image.max()):.4f}]")

    print(f"Saving image to {args.out}...")
    save_png(image, args.out)
    if args.depth:
        # Expected depth, alpha-masked, normalized to [0, 1] for viewing.
        alpha = 1.0 - aux.raster.final_transmittance
        edepth = depth / jnp.maximum(alpha, 1e-6)
        lo = jnp.min(jnp.where(alpha > 0.5, edepth, jnp.inf))
        hi = jnp.max(jnp.where(alpha > 0.5, edepth, -jnp.inf))
        vis = jnp.clip((edepth - lo) / jnp.maximum(hi - lo, 1e-6), 0, 1)
        vis = jnp.where(alpha > 0.05, vis, 1.0)[..., None].repeat(3, -1)
        depth_out = args.out.rsplit(".", 1)[0] + "_depth.png"
        save_png(vis, depth_out)
        print(f"Saved depth map to {depth_out}")
    print("Done.")


if __name__ == "__main__":
    main()
