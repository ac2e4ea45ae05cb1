"""Compress a trained 3DGS scene (PLY or .splat) into the quantized .npz
format, optionally verifying render fidelity before/after.

The reference persists nothing beyond a demo PNG; its oracle library ships
gsplat.compression — this is that capability for this framework
(utils/compress.py).

Usage:
  python examples/compress_scene.py scene.ply out.npz
  python examples/compress_scene.py scene.ply out.npz --verify  # PSNR check
  python examples/compress_scene.py out.npz roundtrip.ply       # decompress
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mojosplat_jax.utils.compress import compress_scene, load_compressed_scene
from mojosplat_jax.utils.ply import load_gaussian_ply, save_gaussian_ply
from mojosplat_jax.utils.runtime import enable_compile_cache


def _load_any(path: str) -> dict:
    if path.endswith(".npz"):
        return load_compressed_scene(path)
    if path.endswith(".splat"):
        from mojosplat_jax.utils.splat import load_gaussian_splat

        return load_gaussian_splat(path)
    return load_gaussian_ply(path)


def _verify_psnr(params_a: dict, params_b: dict, sh_k: int) -> float:
    import jax.numpy as jnp

    from mojosplat_jax import Camera, render_gaussians, look_at
    from mojosplat_jax import train as mtrain

    center = np.asarray(params_a["means3d"]).mean(axis=0)
    extent = float(
        np.percentile(
            np.linalg.norm(params_a["means3d"] - center, axis=-1), 90
        )
    )
    R, T = look_at(
        eye=jnp.asarray(center + np.array([0.0, 0.0, -2.5 * extent - 1e-3])),
        target=jnp.asarray(center),
        up=jnp.array([0.0, 1.0, 0.0]),
    )
    cam = Camera.create(R=R, T=T, H=540, W=960, fx=500.0, fy=500.0,
                        cx=480.0, cy=270.0)
    # K = (degree+1)^2 bases -> degree.
    sh_degree = None if sh_k == 0 else int(round(sh_k**0.5)) - 1

    def render(raw):
        p = mtrain.activate({k: jnp.asarray(v) for k, v in raw.items()})
        return np.asarray(
            render_gaussians(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, sh_degree=sh_degree,
            )
        )

    a, b = render(params_a), render(params_b)
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("src", help="input scene (.ply / .splat / .npz)")
    ap.add_argument("dst", help="output (.npz to compress, .ply to expand)")
    ap.add_argument("--codebook", type=int, default=4096,
                    help="SH-rest K-means codebook size (0 = plain 8-bit)")
    ap.add_argument("--verify", action="store_true",
                    help="render before/after and report PSNR")
    args = ap.parse_args()
    enable_compile_cache()

    params = _load_any(args.src)
    n = params["means3d"].shape[0]
    feats = np.asarray(params["features"])
    sh_k = feats.shape[1] if feats.ndim == 3 else 0

    if args.dst.endswith(".npz"):
        stats = compress_scene(
            args.dst, params,
            sh_codebook_size=None if args.codebook == 0 else args.codebook,
        )
        print(
            f"{n} gaussians (SH K={sh_k}) -> {stats['bytes']/1e6:.2f} MB "
            f"({stats['ratio']:.1f}x smaller than float32)"
        )
        if args.verify:
            back = load_compressed_scene(args.dst)
            print(f"render PSNR vs original: "
                  f"{_verify_psnr(params, back, sh_k):.1f} dB")
    else:
        save_gaussian_ply(args.dst, params)
        print(f"wrote {args.dst} ({n} gaussians)")


if __name__ == "__main__":
    main()
