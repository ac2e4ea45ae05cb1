"""Evaluate a trained 3DGS scene against a COLMAP capture's views.

The held-out evaluation harness standard 3DGS pipelines ship and the
forward-only reference cannot (no dataset loading, no metrics;
/root/reference/render_sample.py renders random clouds only): load a scene
PLY (e.g. the output of examples/train_colmap.py), render every Nth view
through the render pipeline, and report per-view + mean PSNR / SSIM.

    python examples/eval_colmap.py --data /path/to/capture \
        --ply output/train_colmap/fitted.ply --downscale 4 --every 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mojosplat_jax import RenderConfig, render_gaussians, render_surfels  # noqa: E402
from mojosplat_jax import train as mtrain  # noqa: E402
from mojosplat_jax.train import psnr  # noqa: E402
from mojosplat_jax.utils import load_gaussian_ply, save_png  # noqa: E402
from mojosplat_jax.utils import colmap as cm  # noqa: E402
from mojosplat_jax.utils.runtime import enable_compile_cache  # noqa: E402
from train_colmap import load_view_images  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, help="capture root (INRIA layout)")
    ap.add_argument("--ply", required=True, help="trained scene PLY")
    ap.add_argument("--sparse", default=None)
    ap.add_argument("--downscale", type=int, default=4)
    ap.add_argument("--every", type=int, default=8,
                    help="evaluate every Nth view (8 = the standard "
                    "Mip-NeRF-360 test split)")
    ap.add_argument("--impl", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--tile-capacity", type=int, default=512)
    ap.add_argument("--save-renders", default=None,
                    help="directory to dump rendered test views")
    ap.add_argument("--appearance-opt", default="none",
                    choices=["none", "affine", "bilagrid"],
                    help="test-time appearance optimization (the nerf-w "
                    "protocol for appearance-variant captures): fit the "
                    "per-view correction — a 3x4 affine or a bilateral "
                    "grid — on the LEFT half of each ground-truth image, "
                    "report metrics on the RIGHT half (corrected and raw)")
    ap.add_argument("--appearance-steps", type=int, default=100)
    ap.add_argument("--appearance-lr", type=float, default=5e-3)
    ap.add_argument("--appearance-tv", type=float, default=10.0,
                    help="bilateral-grid TV weight during the test-time fit "
                    "(match the trainer's --bilagrid-tv for comparable runs)")
    args = ap.parse_args()
    enable_compile_cache()

    sparse = args.sparse or os.path.join(args.data, "sparse", "0")
    scene = cm.load_scene(sparse)
    views, images = load_view_images(args.data, scene, args.downscale)
    views = views[:: args.every]
    images = images[:: args.every]
    if not views:
        sys.exit("no views selected")
    H, W = images[0].shape[:2]

    params = {
        k: jnp.asarray(v) for k, v in load_gaussian_ply(args.ply).items()
    }
    sh_degree = int(round(params["features"].shape[1] ** 0.5)) - 1
    # Two scale columns = a 2DGS surfel scene (utils/ply.py layout note).
    surfels = params["scales"].shape[-1] == 2
    print(f"{params['means3d'].shape[0]} gaussians, SH degree {sh_degree}; "
          f"{len(views)} test views at {W}x{H}")

    config = RenderConfig(
        tile_capacity=args.tile_capacity, chunk_size=64, max_tile_span=8,
        tile_batch=512, raster_impl=args.impl,
    )

    render_fn = render_surfels if surfels else render_gaussians

    @jax.jit
    def render(p, cam):
        q = mtrain.activate(p) if "opacities_raw" in p else p
        return render_fn(
            q["means3d"], q["scales"], q["quats"], q["opacities"],
            q["features"], cam, sh_degree=sh_degree, config=config,
        )

    if args.save_renders:
        os.makedirs(args.save_renders, exist_ok=True)

    app = args.appearance_opt
    if app != "none":
        import optax

        from mojosplat_jax import (
            apply_bilateral_grid,
            bilateral_grid_tv,
            identity_bilateral_grid,
        )

        opt = optax.adam(args.appearance_lr)

        def correct(img, a):
            return (mtrain.apply_exposure(img, a) if app == "affine"
                    else apply_bilateral_grid(img, a))

        # Fit on full-image coordinates with the loss masked to the left
        # half (keeps the bilateral grid's spatial axes aligned), then
        # score on the right half — the correction never sees the pixels
        # it is judged on. Shapes come from the traced image, so mixed
        # camera resolutions just retrace.
        @jax.jit
        def fit_and_correct(img, tgt):
            a0 = (mtrain.identity_exposure(1)[0] if app == "affine"
                  else identity_bilateral_grid(1)[0])
            h, w, c = img.shape
            # Built during tracing rather than captured as a constant.
            left = (jnp.arange(w) < w // 2).astype(img.dtype)[None, :, None]

            def loss(a):
                err = (correct(img, a) - tgt) ** 2 * left
                l = err.sum() / (h * (w // 2) * c)  # masked per-pixel mean
                if app == "bilagrid":
                    l = l + args.appearance_tv * bilateral_grid_tv(a[None])
                return l

            def body(carry, _):
                a, st = carry
                g = jax.grad(loss)(a)
                u, st = opt.update(g, st)
                return (optax.apply_updates(a, u), st), None

            (a, _), _ = jax.lax.scan(
                body, (a0, opt.init(a0)), None,
                length=args.appearance_steps,
            )
            return correct(img, a)

    rows = []
    for v, target in zip(views, images):
        cam = scene.camera_for(v, args.downscale)
        img = render(params, cam)
        tgt = jnp.asarray(target)
        row = {
            "view": v.name,
            "psnr": float(psnr(img, tgt)),
            "ssim": float(mtrain.ssim(img, tgt)),
        }
        if app != "none":
            fixed = fit_and_correct(img, tgt)
            half = int(tgt.shape[1]) // 2
            row["psnr_right_corrected"] = float(
                psnr(fixed[:, half:], tgt[:, half:])
            )
            row["psnr_right_raw"] = float(
                psnr(img[:, half:], tgt[:, half:])
            )
        rows.append(row)
        extra = (f"  corrected-right {row['psnr_right_corrected']:6.2f}"
                 if app != "none" else "")
        print(f"  {row['view']:>24}  PSNR {row['psnr']:6.2f}  "
              f"SSIM {row['ssim']:.4f}{extra}")
        if args.save_renders:
            save_png(img, os.path.join(
                args.save_renders, os.path.basename(v.name) + ".render.png"
            ))

    summary = {
        "views": len(rows),
        "mean_psnr": float(np.mean([r["psnr"] for r in rows])),
        "mean_ssim": float(np.mean([r["ssim"] for r in rows])),
    }
    if app != "none":
        summary["mean_psnr_right_corrected"] = float(
            np.mean([r["psnr_right_corrected"] for r in rows])
        )
        summary["mean_psnr_right_raw"] = float(
            np.mean([r["psnr_right_raw"] for r in rows])
        )
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
