"""Extract a triangle mesh from a trained 2DGS surfel scene.

The 2DGS paper's reconstruction pipeline (Huang et al. 2024, sec. 5):
render per-view INTERSECTION depth maps from the trained surfels, fuse them
into a TSDF volume, extract the isosurface (utils/mesh.py: JAX TSDF fusion
+ vectorized marching tetrahedra). Self-contained — no open3d.

Usage:
  python examples/extract_mesh.py fitted_surfels.ply out_mesh.ply
  python examples/extract_mesh.py fitted.ply out.obj --views 24 --res 256
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from mojosplat_jax import Camera, RenderConfig, look_at
from mojosplat_jax import train as mtrain
from mojosplat_jax.surfel import render_surfels
from mojosplat_jax.utils.mesh import (
    marching_tetrahedra,
    save_mesh_obj,
    save_mesh_ply,
    tsdf_fuse,
)
from mojosplat_jax.utils.ply import load_gaussian_ply
from mojosplat_jax.utils.runtime import enable_compile_cache


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="trained surfel scene (.ply, 2DGS layout)")
    ap.add_argument("dst", help="output mesh (.ply or .obj)")
    ap.add_argument("--views", type=int, default=16,
                    help="orbit depth views to fuse")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--res", type=int, default=192, help="TSDF grid res")
    ap.add_argument("--elevations", type=float, nargs="+",
                    default=[-0.2, 0.25, 0.6])
    ap.add_argument("--alpha-floor", type=float, default=0.5)
    ap.add_argument("--margin", type=float, default=0.1,
                    help="grid margin as a fraction of the scene extent")
    args = ap.parse_args()
    enable_compile_cache()

    raw = load_gaussian_ply(args.src)
    p = mtrain.activate({k: jnp.asarray(v) for k, v in raw.items()})
    feats = raw["features"]
    # PLY features are SH coefficients (K = (deg+1)^2 bases).
    sh_degree = (None if feats.ndim == 2
                 else int(round(feats.shape[1] ** 0.5)) - 1)
    means = np.asarray(raw["means3d"])
    center = means.mean(axis=0)
    extent = float(np.percentile(
        np.linalg.norm(means - center, axis=-1), 95))
    lo = center - (1.0 + args.margin) * extent
    hi = center + (1.0 + args.margin) * extent
    radius = 2.6 * extent
    H, W = args.height, args.width
    focal = 0.7 * W

    config = RenderConfig(tile_capacity=512, chunk_size=64)

    @jax.jit
    def depth_view(params, cam):
        img, depth, aux = render_surfels(
            params["means3d"], params["scales"], params["quats"],
            params["opacities"], params["features"], cam,
            sh_degree=sh_degree, config=config,
            return_depth=True, return_aux=True,
        )
        alpha = 1.0 - aux.raster.final_transmittance
        # Expected (alpha-divided) intersection depth; dummy 0 where empty.
        edepth = jnp.where(alpha > 1e-3, depth / jnp.maximum(alpha, 1e-3),
                           0.0)
        return edepth, alpha

    cams, depths, alphas = [], [], []
    t0 = time.perf_counter()
    n_az = max(1, args.views // len(args.elevations))
    for el in args.elevations:
        for i in range(n_az):
            az = 2.0 * np.pi * i / n_az + 0.5 * el  # stagger rings
            eye = center + radius * np.array(
                [np.sin(az) * np.cos(el), np.sin(el),
                 np.cos(az) * np.cos(el)]
            )
            R, T = look_at(eye=jnp.asarray(eye, jnp.float32),
                           target=jnp.asarray(center, jnp.float32),
                           up=jnp.array([0.0, 1.0, 0.0]))
            cam = Camera.create(R=R, T=T, H=H, W=W, fx=focal, fy=focal,
                                cx=W / 2, cy=H / 2)
            ed, al = depth_view(p, cam)
            cams.append(cam)
            depths.append(np.asarray(ed))
            alphas.append(np.asarray(al))
    print(f"rendered {len(cams)} depth views in "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    tsdf, w, origin, spacing = tsdf_fuse(
        depths, alphas, cams, (lo, hi), resolution=args.res,
        alpha_floor=args.alpha_floor,
    )
    print(f"fused TSDF {args.res}^3 in {time.perf_counter() - t0:.1f} s "
          f"({(w > 0).mean() * 100:.1f}% observed)")

    t0 = time.perf_counter()
    verts, faces = marching_tetrahedra(
        tsdf, origin=origin, spacing=spacing, mask=w > 0
    )
    print(f"extracted {len(verts)} verts / {len(faces)} faces in "
          f"{time.perf_counter() - t0:.1f} s")

    if args.dst.endswith(".obj"):
        save_mesh_obj(args.dst, verts, faces)
    else:
        save_mesh_ply(args.dst, verts, faces)
    print(f"wrote {args.dst}")


if __name__ == "__main__":
    main()
