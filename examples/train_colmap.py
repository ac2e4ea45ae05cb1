"""Train a 3DGS scene from a real COLMAP capture.

The full real-data training path the reference cannot offer (it is
forward-only with no dataset loading, /root/reference/mojosplat/render.py:11,
README.md:145): parse a COLMAP sparse model (native C parsers), initialize
gaussians from the SfM point cloud, and optimize them against the captured
images with the standard D-SSIM + L1 photometric loss — all through the
differentiable pipeline with static shapes (one compile for the whole
run).

    python examples/train_colmap.py --data /path/to/capture \
        --downscale 4 --steps 2000 --impl pallas

Expects the INRIA layout: <data>/images/*.{png,jpg} and
<data>/sparse/0/{cameras,images,points3D}.bin.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mojosplat_jax import (
    RenderConfig,
    apply_bilateral_grid,
    apply_pose_delta,
    bilateral_grid_tv,
    identity_bilateral_grid,
    render_gaussians,
    render_surfels,
)
from mojosplat_jax.surfel import normal_consistency_loss
from mojosplat_jax import train as mtrain
from mojosplat_jax.utils import save_gaussian_ply, save_png
from mojosplat_jax.utils import colmap as cm
from mojosplat_jax.utils.runtime import enable_compile_cache


def load_view_images(data_dir, scene, downscale):
    """Load every registered view's image, downscaled, as float32 [0,1]."""
    from PIL import Image

    images_dir = os.path.join(data_dir, "images")
    out, views = [], []
    for im in scene.images:
        path = os.path.join(images_dir, im.name)
        if not os.path.exists(path):
            print(f"  skipping {im.name}: file not found")
            continue
        img = Image.open(path).convert("RGB")
        if downscale > 1:
            img = img.resize(
                (img.width // downscale, img.height // downscale),
                Image.LANCZOS,
            )
        out.append(np.asarray(img, np.float32) / 255.0)
        views.append(im)
    return views, out


def round_up(n, m):
    return -(-n // m) * m


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", required=True, help="capture root (INRIA layout)")
    ap.add_argument("--sparse", default=None,
                    help="sparse model dir (default <data>/sparse/0)")
    ap.add_argument("--downscale", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--primitive", default="3dgs", choices=["3dgs", "2dgs"],
                    help="'2dgs' trains gaussian surfels (Huang et al.): "
                    "(N,2) tangent scales, exact ray/disk intersection "
                    "response, the paper's depth-distortion and normal-"
                    "consistency regularizers; the trained PLY feeds "
                    "examples/extract_mesh.py")
    ap.add_argument("--normal-weight", type=float, default=0.05,
                    help="2DGS normal-consistency regularizer weight")
    ap.add_argument("--distortion-weight", type=float, default=100.0,
                    help="2DGS depth-distortion regularizer weight")
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--ssim-weight", type=float, default=0.2)
    ap.add_argument("--impl", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--tile-capacity", type=int, default=512)
    ap.add_argument("--capacity-mult", type=int, default=4,
                    help="intersection capacity as a multiple of N")
    ap.add_argument(
        "--tight-cull", action="store_true",
        help="contribution-aware intersection culling (3DGS only): drop "
        "AABB tile slots whose peak alpha cannot reach the blend "
        "threshold, so the capacity budget holds only contributing slots",
    )
    ap.add_argument("--max-gaussians", type=int, default=0,
                    help="static capacity (0 = round points up to 64k)")
    ap.add_argument("--out-dir", default="output/train_colmap")
    ap.add_argument("--save-every", type=int, default=500)
    ap.add_argument(
        "--strategy", default="none", choices=["none", "mcmc", "adc"],
        help="density control: 'mcmc' = 3DGS-MCMC relocation + opacity-"
        "gated noise + L1 regularizers; 'adc' = the INRIA clone/split/"
        "prune family driven by accumulated view-space positional "
        "gradients. Both run at fixed capacity (padded slots).",
    )
    ap.add_argument("--densify-every", type=int, default=100,
                    help="steps between density-control events")
    ap.add_argument("--densify-grad-threshold", type=float, default=2e-6,
                    help="ADC mean view-space gradient threshold for "
                    "clone/split candidates")
    ap.add_argument("--absgrad", action="store_true",
                    help="ADC statistic = absolute per-tile view-space "
                    "gradients (AbsGS; needs --impl pallas; use a 2-4x "
                    "higher --densify-grad-threshold)")
    ap.add_argument("--opacity-reset-every", type=int, default=0,
                    help="INRIA periodic opacity reset (e.g. 3000): clamp "
                    "live opacities so ADC pruning can reclaim stale slots")
    ap.add_argument("--sh-warmup-every", type=int, default=0,
                    help="raise the active SH degree by one every N steps "
                    "(INRIA schedule: 1000), starting from DC only; the "
                    "full coefficient set is allocated up front so each "
                    "degree is one recompile, no reshapes")
    ap.add_argument("--depth-loss", type=float, default=0.0,
                    help="weight of the sparse SfM depth supervision "
                    "(L1 disparity at the COLMAP keypoints, "
                    "train.sparse_depth_loss); anchors geometry to the "
                    "triangulation so floaters collapse")
    ap.add_argument("--pose-opt", action="store_true",
                    help="jointly refine camera poses: per-view se(3) "
                    "deltas (apply_pose_delta) optimized with selective "
                    "Adam, correcting COLMAP extrinsic noise")
    ap.add_argument("--pose-lr", type=float, default=1e-4)
    ap.add_argument("--exposure-opt", action="store_true",
                    help="per-view affine color correction "
                    "(train.apply_exposure) absorbing auto-exposure/white-"
                    "balance drift; optimized with selective Adam")
    ap.add_argument("--exposure-lr", type=float, default=1e-3)
    ap.add_argument("--bilagrid", action="store_true",
                    help="per-view bilateral-grid color correction "
                    "(bilagrid.apply_bilateral_grid): a low-res (16,16,8) "
                    "grid of 3x4 affines over (y, x, luma) absorbing "
                    "spatially-varying photometric nuisance (vignetting, "
                    "local white balance) that the global --exposure-opt "
                    "affine cannot; optimized with selective Adam")
    ap.add_argument("--bilagrid-lr", type=float, default=2e-3)
    ap.add_argument("--bilagrid-tv", type=float, default=10.0,
                    help="total-variation weight keeping each view's grid "
                    "smooth so it cannot memorize scene detail")
    ap.add_argument("--intrinsics-opt", action="store_true",
                    help="refine per-view intrinsics: (log-focal x/y, "
                    "principal point x/y) deltas — self-calibration for "
                    "imprecise COLMAP intrinsics")
    ap.add_argument("--intrinsics-lr", type=float, default=1e-4)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save an Orbax checkpoint (train state + view "
                    "nuisance params) every N steps")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <out-dir>/ckpt if present")
    ap.add_argument("--multihost", action="store_true",
                    help="initialize jax.distributed before training "
                    "(launch this CLI on every process; configure with "
                    "MOJOSPLAT_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID)")
    args = ap.parse_args()
    enable_compile_cache()

    from mojosplat_jax.parallel import init_multihost, is_primary

    # Must precede backend initialization; single-host no-op by default.
    init_multihost(require=args.multihost)
    if not is_primary():
        # Workers participate in every collective but must not race the
        # primary on the shared out_dir (checkpoint rmtree/rename, PLY and
        # PNG writes) or duplicate logging. Filesystem writes below are
        # all guarded by this rebind + the primary-only save paths.
        import builtins

        builtins.print = lambda *a, **k: None
    os.makedirs(args.out_dir, exist_ok=True)

    sparse = args.sparse or os.path.join(args.data, "sparse", "0")
    print(f"Loading COLMAP model from {sparse}")
    scene = cm.load_scene(sparse, with_points2d=args.depth_loss > 0)
    print(f"  {len(scene.cameras)} cameras, {len(scene.images)} images, "
          f"{scene.points_xyz.shape[0]} points")

    views, images = load_view_images(args.data, scene, args.downscale)
    if not views:
        sys.exit("no images found")
    H, W = images[0].shape[:2]
    if any(im.shape[:2] != (H, W) for im in images):
        sys.exit("mixed image sizes are not supported (one camera assumed)")
    targets = jnp.asarray(np.stack(images))
    cameras = [scene.camera_for(v, args.downscale) for v in views]
    cams = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cameras)
    print(f"  {len(views)} views at {W}x{H}")

    depth_sup = args.depth_loss > 0
    if depth_sup:
        uv_np, dz_np, dm_np = cm.sparse_depth_targets(
            scene, views, args.downscale
        )
        dt_uv, dt_z, dt_m = map(jnp.asarray, (uv_np, dz_np, dm_np))
        print(f"  depth supervision: {int(dm_np.sum())} SfM targets "
              f"({dm_np.shape[1]} slots/view)")
    else:
        # Unused placeholders so step_fn keeps one signature.
        dt_uv = jnp.zeros((len(views), 1, 2), jnp.float32)
        dt_z = jnp.ones((len(views), 1), jnp.float32)
        dt_m = jnp.zeros((len(views), 1), bool)

    # Static parameter capacity: pad the SfM cloud up to a fixed bucket so
    # the whole run is one compile.
    raw_np = cm.init_gaussians_from_points(
        scene.points_xyz, scene.points_rgb, sh_degree=args.sh_degree
    )
    surfels = args.primitive == "2dgs"
    if surfels:
        # Surfels live in their tangent plane: (N, 2) log scales.
        raw_np["scales"] = raw_np["scales"][:, :2]
    n_pts = scene.points_xyz.shape[0]
    cap = args.max_gaussians or round_up(max(n_pts, 1), 65536)
    raw = {k: jnp.asarray(v) for k, v in raw_np.items()}
    if cap > n_pts:
        from mojosplat_jax.densify import pad_to_capacity

        raw = pad_to_capacity(raw, cap)
        print(f"  padded {n_pts} -> {cap} gaussian slots")

    config = RenderConfig(
        tile_capacity=args.tile_capacity, chunk_size=64, max_tile_span=8,
        tile_batch=512, raster_impl=args.impl,
        isect_padding_multiplier=args.capacity_mult,
        tight_cull=args.tight_cull and not surfels,
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

    adc = args.strategy == "adc"
    if adc and surfels:
        sys.exit("--strategy adc needs the 3DGS view-space gradient sink; "
                 "use --strategy mcmc with --primitive 2dgs")
    if adc:
        from mojosplat_jax.densify import (
            DensifyConfig,
            DensifyState,
            accumulate_stats,
            densify_and_prune,
            reset_opacities,
        )
        from mojosplat_jax.ops.projection import project_gaussians

        # Scene extent for the split/clone size thresholds: radius of the
        # camera rig (the INRIA trainer's cameras_extent).
        centers = -np.einsum(
            "vji,vj->vi", np.asarray(cams.R), np.asarray(cams.T)
        )
        extent = float(
            1.1 * np.max(np.linalg.norm(centers - centers.mean(0), axis=-1))
        ) or 1.0
        print(f"  ADC scene extent {extent:.3f}")
        densify_fn = jax.jit(functools.partial(
            densify_and_prune, scene_extent=extent,
            config=DensifyConfig(
                grad_threshold=args.densify_grad_threshold
            ),
        ))
        dstate = DensifyState.zero(cap)
    else:
        dstate = None

    # Per-view nuisance state (pose se(3) deltas, exposure affines),
    # stepped by selective Adam with per-group learning rates: only the
    # view rendered this step has a nonzero gradient row; the others keep
    # frozen moments, and a disabled group's all-zero gradients freeze it
    # entirely.
    view_transforms = {
        "pose": mtrain.selective_adam(args.pose_lr),
        "expo": mtrain.selective_adam(args.exposure_lr),
        "intr": mtrain.selective_adam(args.intrinsics_lr),
    }
    view_params = {
        "pose": jnp.zeros((len(views), 6), jnp.float32),
        "expo": mtrain.identity_exposure(len(views)),
        "intr": jnp.zeros((len(views), 4), jnp.float32),
    }
    if args.bilagrid:
        # Allocated only when enabled: the gated tree keeps pre-bilagrid
        # checkpoints resumable.
        view_transforms["bgrid"] = mtrain.selective_adam(args.bilagrid_lr)
        view_params["bgrid"] = identity_bilateral_grid(len(views))
    view_opt = optax.multi_transform(
        view_transforms, {k: k for k in view_transforms}
    )
    view_state = view_opt.init(view_params)

    ckpt_dir = os.path.join(os.path.abspath(args.out_dir), "ckpt")
    start_step = 0
    if args.resume and os.path.isdir(ckpt_dir):
        from mojosplat_jax.utils.checkpoint import restore_checkpoint

        like = dict(state=state, view_params=view_params,
                    view_state=view_state)
        # The ADC gradient-accumulation window is part of training state:
        # dropping it on resume silently resets densification statistics.
        if dstate is not None:
            like["dstate"] = dstate
        def bilagrid_hint(e):
            if args.bilagrid and "bgrid" in view_params:
                raise SystemExit(
                    "checkpoint restore failed — if --bilagrid was enabled "
                    "AFTER this checkpoint was written, the optimizer trees "
                    "no longer match; restart without --resume or retrain "
                    f"with the original flags.\n  underlying error: {e}"
                )
            raise e

        try:
            bundle = restore_checkpoint(ckpt_dir, like=like)
        except Exception as first_err:
            if dstate is None:
                bilagrid_hint(first_err)
            # Pre-round-4 checkpoints carry no dstate — retry without it
            # and keep the zero window. If the retry ALSO fails, the
            # failure was never about dstate: surface the ORIGINAL error.
            del like["dstate"]
            try:
                bundle = restore_checkpoint(ckpt_dir, like=like)
            except Exception:
                bilagrid_hint(first_err)
            print("  note: checkpoint has no densify stats; "
                  "accumulation window restarts at zero")
        state = mtrain.TrainState(*bundle["state"])
        view_params = bundle["view_params"]
        view_state = bundle["view_state"]
        if dstate is not None and "dstate" in bundle:
            from mojosplat_jax.densify import DensifyState as _DState

            dstate = _DState(*bundle["dstate"])
        start_step = int(state.step)
        print(f"  resumed from {ckpt_dir} at step {start_step}")

    def save_ckpt():
        from mojosplat_jax.utils.checkpoint import save_checkpoint
        import shutil

        tmp = ckpt_dir + ".tmp"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        bundle = dict(state=state, view_params=view_params,
                      view_state=view_state)
        if dstate is not None:
            bundle["dstate"] = dstate
        save_checkpoint(tmp, bundle)
        if os.path.isdir(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        os.rename(tmp, ckpt_dir)

    @functools.partial(
        jax.jit, donate_argnums=(0, 1, 2, 3), static_argnums=(11,)
    )
    def step_fn(st, vp, vstate, dstate, view_idx, cam, target, key,
                duv, dz, dm, sh_deg):
        def posed(v):
            c = (apply_pose_delta(cam, v["pose"][view_idx])
                 if args.pose_opt else cam)
            if args.intrinsics_opt:
                di = v["intr"][view_idx]
                c = dataclasses.replace(
                    c, fx=c.fx * jnp.exp(di[0]), fy=c.fy * jnp.exp(di[1]),
                    cx=c.cx + di[2], cy=c.cy + di[3],
                )
            return c

        def loss_fn(params, v, offset):
            p = mtrain.activate(params)
            c = posed(v)
            sink = {}
            if adc:
                # Zero view-space offset whose cotangent is the per-step
                # positional-gradient statistic driving clone/split.
                sink = ({"absgrad_sink": offset} if args.absgrad
                        else {"means2d_offset": offset})
            if surfels:
                img, dmap, nmap, dist, raux = render_surfels(
                    p["means3d"], p["scales"], p["quats"], p["opacities"],
                    p["features"], c, sh_degree=sh_deg, config=config,
                    return_depth=True, return_normals=True,
                    return_distortion=True, return_aux=True,
                )
            elif depth_sup:
                img, dmap, raux = render_gaussians(
                    p["means3d"], p["scales"], p["quats"], p["opacities"],
                    p["features"], c, sh_degree=sh_deg,
                    config=config, return_depth=True, return_aux=True,
                    **sink,
                )
            else:
                img = render_gaussians(
                    p["means3d"], p["scales"], p["quats"], p["opacities"],
                    p["features"], c, sh_degree=sh_deg,
                    config=config, **sink,
                )
            if args.exposure_opt:
                img = mtrain.apply_exposure(img, v["expo"][view_idx])
            if args.bilagrid:
                img = apply_bilateral_grid(img, v["bgrid"][view_idx])
            loss = mtrain.dssim_l1_loss(
                img, target, ssim_weight=args.ssim_weight
            )
            if args.bilagrid:
                # TV on THIS view's grid only: other views' rows keep an
                # exactly-zero gradient, so selective Adam leaves them
                # frozen (same contract as pose/exposure).
                loss = loss + args.bilagrid_tv * bilateral_grid_tv(
                    v["bgrid"][view_idx]
                )
            if depth_sup:
                alpha = 1.0 - raux.raster.final_transmittance
                loss = loss + args.depth_loss * mtrain.sparse_depth_loss(
                    dmap, alpha, duv, dz, dm
                )
            if surfels:
                # The 2DGS paper's regularizers (surfel.py; same
                # normalization as train.train_step_sharded_surfel).
                if args.distortion_weight:
                    loss = loss + args.distortion_weight * jnp.mean(dist)
                if args.normal_weight:
                    loss = loss + args.normal_weight * (
                        normal_consistency_loss(
                            dmap, nmap, raux.raster.final_transmittance, c
                        )
                    )
            if mcmc:
                loss = loss + mcmc_regularization(params, mcfg)
            return loss

        offset0 = jnp.zeros((cap, 2), jnp.float32)
        if adc:
            loss, (grads, view_grads, ograd) = jax.value_and_grad(
                loss_fn, argnums=(0, 1, 2)
            )(st.params, vp, offset0)
            p = mtrain.activate(st.params)
            proj = project_gaussians(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                posed(vp), config,
            )
            dstate = accumulate_stats(dstate, ograd, proj.radii[:, 0] > 0)
        else:
            loss, (grads, view_grads) = jax.value_and_grad(
                loss_fn, argnums=(0, 1)
            )(st.params, vp, offset0)
        updates, opt_state = optimizer.update(
            grads, st.opt_state, st.params
        )
        params = optax.apply_updates(st.params, updates)
        if (args.pose_opt or args.exposure_opt or args.intrinsics_opt
                or args.bilagrid):
            vd, vstate = view_opt.update(view_grads, vstate, vp)
            vp = optax.apply_updates(vp, vd)
        if mcmc:
            # Exploration noise inside the jitted step (no extra dispatch).
            params = mcmc_position_noise(params, key, args.lr, mcfg)
        return (
            mtrain.TrainState(params, opt_state, st.step + 1),
            vp, vstate, dstate, loss,
        )

    @jax.jit
    def render_view(params, cam):
        p = mtrain.activate(params)
        fn = render_surfels if surfels else render_gaussians
        return fn(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, sh_degree=args.sh_degree, config=config,
        )

    def cam_at(i):
        return jax.tree_util.tree_map(lambda x: x[i], cams)

    n_views = len(views)
    rng = np.random.default_rng(0)
    base_key = jax.random.PRNGKey(17)
    t0 = time.perf_counter()
    losses = []
    for step in range(start_step, args.steps):
        i = int(rng.integers(n_views))
        active_sh = (min(args.sh_degree, step // args.sh_warmup_every)
                     if args.sh_warmup_every else args.sh_degree)
        state, view_params, view_state, dstate, loss = step_fn(
            state, view_params, view_state, dstate, jnp.int32(i),
            cam_at(i), targets[i], jax.random.fold_in(base_key, step),
            dt_uv[i], dt_z[i], dt_m[i], active_sh,
        )
        losses.append(loss)
        if adc and (step + 1) % args.densify_every == 0 \
                and step + 1 < args.steps:
            params, dstate, metrics = densify_fn(
                state.params, dstate,
                jax.random.fold_in(base_key, 2 * args.steps + step + 1),
            )
            # Fresh optimizer state for the mutated parameter set.
            state = mtrain.TrainState(
                params, optimizer.init(params), state.step
            )
            print(f"  [densify: +{int(metrics['cloned'])} cloned, "
                  f"+{int(metrics['split'])} split, "
                  f"-{int(metrics['pruned'])} pruned, "
                  f"{int(metrics['alive'])} alive]", flush=True)
        if adc and args.opacity_reset_every and \
                (step + 1) % args.opacity_reset_every == 0 \
                and step + 1 < args.steps:
            params = reset_opacities(state.params)
            state = mtrain.TrainState(
                params, optimizer.init(params), state.step
            )
            print("  [opacity reset]", flush=True)
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
        if (is_primary() and args.save_every
                and (step + 1) % args.save_every == 0):
            ply = os.path.join(args.out_dir, f"scene_{step + 1:06d}.ply")
            save_gaussian_ply(ply, jax.device_get(state.params))
            print(f"  saved {ply}")
        if (is_primary() and args.ckpt_every
                and (step + 1) % args.ckpt_every == 0):
            save_ckpt()
            print(f"  checkpointed step {step + 1} -> {ckpt_dir}")

    # Final artifacts: scene PLY + a rendered/target pair for view 0
    # (process 0 only — workers must not race the shared out_dir).
    if not is_primary():
        return
    save_gaussian_ply(os.path.join(args.out_dir, "scene_final.ply"),
                      jax.device_get(state.params))
    if args.pose_opt:
        d = np.asarray(view_params["pose"])
        rot_deg = np.degrees(np.linalg.norm(d[:, :3], axis=-1))
        trans = np.linalg.norm(d[:, 3:], axis=-1)
        print(f"pose refinement: mean correction {rot_deg.mean():.4f} deg / "
              f"{trans.mean():.5f} units (max {rot_deg.max():.4f} deg / "
              f"{trans.max():.5f})")
        np.save(os.path.join(args.out_dir, "pose_deltas.npy"), d)
    if args.exposure_opt:
        e = np.asarray(view_params["expo"])
        dev = np.abs(e - np.asarray(mtrain.identity_exposure(len(views))))
        print(f"exposure refinement: mean |affine - identity| "
              f"{dev.mean():.5f} (max {dev.max():.5f})")
        np.save(os.path.join(args.out_dir, "exposure_affines.npy"), e)
    if args.bilagrid:
        g = np.asarray(view_params["bgrid"])
        dev = np.abs(g - np.asarray(identity_bilateral_grid(len(views))))
        print(f"bilateral grids: mean |grid - identity| {dev.mean():.5f} "
              f"(max {dev.max():.5f})")
        np.save(os.path.join(args.out_dir, "bilateral_grids.npy"), g)
    if args.intrinsics_opt:
        di = np.asarray(view_params["intr"])
        print(f"intrinsics refinement: mean |dlog f| "
              f"{np.abs(di[:, :2]).mean():.5f}, mean |dc| "
              f"{np.abs(di[:, 2:]).mean():.4f} px")
        np.save(os.path.join(args.out_dir, "intrinsics_deltas.npy"), di)
    cam0 = cam_at(0)
    if args.pose_opt:
        cam0 = apply_pose_delta(cam0, view_params["pose"][0])
    if args.intrinsics_opt:
        di = view_params["intr"][0]
        cam0 = dataclasses.replace(
            cam0, fx=cam0.fx * jnp.exp(di[0]), fy=cam0.fy * jnp.exp(di[1]),
            cx=cam0.cx + di[2], cy=cam0.cy + di[3],
        )
    img = np.asarray(render_view(state.params, cam0))
    save_png(img, os.path.join(args.out_dir, "render_view0.png"))
    save_png(np.asarray(targets[0]),
             os.path.join(args.out_dir, "target_view0.png"))
    print(f"Done: artifacts in {args.out_dir}")


if __name__ == "__main__":
    main()
