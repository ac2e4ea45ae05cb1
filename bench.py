"""Benchmark: pixels/s of one render step on one NVIDIA GPU.

Prints ONE JSON line with the metric, the step time, the drop counters of
the static budgets, the roofline share and the device (``device_kind`` and
nvidia-smi's name and power limit). It refuses to run without a GPU.

Each timed call is one jitted step (forward, or forward+backward) ending in
``block_until_ready``; the reported time is the median of ``--iters`` calls
after a warm-up call that compiles.

    python bench.py                  # 1M gaussians, 1080p, SH3, fwd+bwd
    python bench.py --preset 3       # 100k gaussians, 800x600, fwd+bwd
    python bench.py --preset 6       # the trained 1M scene at 1080p
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import jax
import jax.numpy as jnp

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax import train as mtrain
from mojosplat_jax.utils.runtime import (
    enable_compile_cache,
    gpu_name_and_power_limit,
    require_gpu,
)


def load_scene_params(path):
    """Trained-scene params from a compressed .npz or gaussian .ply."""
    if path.endswith(".npz"):
        from mojosplat_jax.utils.compress import load_compressed_scene

        raw = load_compressed_scene(path)
    else:
        from mojosplat_jax.utils.ply import load_gaussian_ply

        raw = load_gaussian_ply(path)
    return mtrain.activate({k: jnp.asarray(v) for k, v in raw.items()})


def scene_camera(H, W):
    """Deterministic eval view of the synthetic capture's scene: the ring
    convention of scripts/make_synth_colmap.py (orbit radius 3.9, target
    [0, 0.4, 0], fx = 0.72 W) at an angle none of the training views use."""
    import numpy as np

    ang = 0.618  # golden-angle-ish: between training views
    eye = np.array([3.9 * np.sin(ang), -0.75, 3.9 * np.cos(ang)])
    up = np.array([0.0, 1.0, 0.0])
    forward = np.array([0.0, 0.4, 0.0]) - eye
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    R = np.stack([right, down, forward]).astype(np.float32)
    T = (-R @ eye).astype(np.float32)
    return Camera.create(
        R=R, T=T, H=H, W=W, fx=0.72 * W, fy=0.72 * W, cx=W / 2, cy=H / 2,
    )


def build_step(n, H, W, sh_degree, config, mode, family="3dgs",
               maps=False, scene_params=None):
    if scene_params is not None:
        params = scene_params
        camera = scene_camera(H, W)
    else:
        camera = Camera.create(
            R=jnp.eye(3), T=jnp.zeros(3), H=H, W=W,
            fx=0.5 * W, fy=0.5 * W, cx=W / 2, cy=H / 2,
        )
        params = mtrain.activate(
            mtrain.init_gaussians(
                jax.random.PRNGKey(0), n, sh_degree=sh_degree,
                position_scale=2.0,
            )
        )
    if family == "2dgs":
        from mojosplat_jax.surfel import render_surfels

        params["scales"] = params["scales"][:, :2]  # disks
        render = render_surfels
    else:
        render = render_gaussians

    def aux_counters(p, cam):
        # Honest-headline counters: how much blend work the static budgets
        # (max_tile_span / capacity / tile_capacity) actually dropped for
        # this scene. Forward-only; compiled separately from the timed loop.
        out = render(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, sh_degree=sh_degree,
            background_color=jnp.array([0.1, 0.1, 0.1]), config=config,
            return_aux=True,
        )
        aux = out[-1]
        return (aux.binning.num_isects, aux.binning.capacity_overflow,
                aux.binning.span_truncated, aux.raster.tile_overflow,
                aux.binning.tight_culled)

    def forward(p, cam):
        if maps:
            # Full 2DGS output surface: rgb + intersection depth + normals
            # + distortion map (the training configuration with the
            # paper's regularizers).
            img, depth, normal, dist = render(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, sh_degree=sh_degree,
                background_color=jnp.array([0.1, 0.1, 0.1]), config=config,
                return_depth=True, return_normals=True,
                return_distortion=True,
            )
            return (jnp.mean(img**2) + 1e-3 * jnp.mean(depth**2)
                    + 1e-3 * jnp.mean(normal**2) + 1e-3 * jnp.mean(dist))
        return render(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, sh_degree=sh_degree,
            background_color=jnp.array([0.1, 0.1, 0.1]), config=config,
        )

    def scalar(p, cam):
        out = forward(p, cam)
        # maps mode already returns the combined scalar loss; the plain
        # mode keeps the historical reductions (sum fwd / mean-square
        # fwdbwd) so metrics stay comparable across rounds.
        if maps:
            return out
        return jnp.sum(out) if mode == "fwd" else jnp.mean(out**2)

    def one(p, cam):
        if mode == "fwd":
            return scalar(p, cam)
        return jax.value_and_grad(scalar)(p, cam)

    return jax.jit(one), params, camera, jax.jit(aux_counters)


# Measurement configs (BASELINE.md numbering; 5 is the sharded training
# step, run by chip_smoke.py --four-cards). Preset 4 is the random-cloud
# stress cell: its span and capacity budgets drop most of the blend work it
# demands, so read it beside isect_keep_fraction. Preset 6 is the trained
# scene with capacity open enough that isect_keep_fraction ~ 1.
PRESETS = {
    1: dict(gaussians=1_000, height=256, width=256, sh_degree=-1, mode="fwd",
            tile_size=16, span=8, capacity_mult=4, tile_capacity=512),
    2: dict(gaussians=100_000, height=600, width=800, sh_degree=-1,
            mode="fwd", tile_size=16, span=8, capacity_mult=4,
            tile_capacity=512),
    3: dict(gaussians=100_000, height=600, width=800, sh_degree=-1,
            mode="fwdbwd", tile_size=16, span=8, capacity_mult=4,
            tile_capacity=512),
    4: dict(gaussians=1_000_000, height=1080, width=1920, sh_degree=3,
            mode="fwdbwd", tile_size=32, span=4,
            capacity_mult=1, tile_capacity=512),
    6: dict(scene="assets/trained_scene_1m.npz", height=1080, width=1920,
            sh_degree=3, mode="fwdbwd", tile_size=32, span=4,
            capacity_mult=8, tile_capacity=512, tight_cull=True),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", type=int, choices=sorted(PRESETS),
                    help="BASELINE.md measurement config number")
    ap.add_argument("--gaussians", type=int, default=1_000_000)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--mode", choices=["fwd", "fwdbwd"], default="fwdbwd")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--impl", default=None, choices=["xla", "pallas"],
                    help="raster route (default: pallas for 3dgs, xla for "
                    "2dgs, which has no kernel)")
    ap.add_argument("--tile-size", type=int, default=32,
                    help="raster tile size in pixels")
    ap.add_argument("--span", type=int, default=4,
                    help="max tile span per gaussian per axis")
    ap.add_argument("--capacity-mult", type=int, default=1,
                    help="intersection capacity as a multiple of N")
    ap.add_argument("--tile-capacity", type=int, default=512,
                    help="per-tile slot capacity")
    ap.add_argument(
        "--tight-cull", action=argparse.BooleanOptionalAction,
        default=False,
        help="contribution-aware intersection culling (3DGS only): drop "
        "AABB slots whose peak alpha over the tile cannot reach the blend "
        "threshold",
    )
    ap.add_argument(
        "--family", default="3dgs", choices=["3dgs", "2dgs"],
        help="primitive family (metric name gets a _2dgs suffix)",
    )
    ap.add_argument(
        "--maps", action="store_true",
        help="2dgs only: render the full output surface (depth/normal/"
        "distortion maps); metric suffix _maps",
    )
    ap.add_argument(
        "--scene", default=None,
        help="render a trained scene artifact (.npz compressed or .ply) "
        "instead of the random-init cloud; the metric name gains a "
        "_trained suffix and --gaussians is taken from the file",
    )
    args = ap.parse_args()
    if args.maps and args.family != "2dgs":
        ap.error("--maps requires --family 2dgs")
    if args.preset is not None:
        for k, v in PRESETS[args.preset].items():
            setattr(args, k.replace("-", "_"), v)
    if args.impl is None:
        args.impl = "pallas" if args.family == "3dgs" else "xla"

    dev = require_gpu()
    enable_compile_cache()
    config = RenderConfig(
        tile_size=args.tile_size,
        tile_capacity=args.tile_capacity,
        chunk_size=64,
        tile_batch=512,
        max_tile_span=args.span,
        isect_padding_multiplier=args.capacity_mult,
        tight_cull=args.tight_cull,
        raster_impl=args.impl,
    )
    sh = args.sh_degree if args.sh_degree >= 0 else None
    scene_params = None
    if args.scene:
        scene_params = load_scene_params(args.scene)
        args.gaussians = int(scene_params["means3d"].shape[0])
        k = scene_params["features"].shape[1]
        args.sh_degree = int(round(k ** 0.5)) - 1
        sh = args.sh_degree
    step, params, camera, aux_fn = build_step(
        args.gaussians, args.height, args.width, sh, config, args.mode,
        family=args.family, maps=args.maps, scene_params=scene_params,
    )

    t0 = time.perf_counter()
    jax.block_until_ready(step(params, camera))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        jax.block_until_ready(step(params, camera))
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)

    metric = (
        f"pixels_per_s_{args.mode}_{args.gaussians // 1000}k_"
        f"{args.height}p_sh{args.sh_degree}"
        + ("_2dgs" if args.family == "2dgs" else "")
        + ("_maps" if args.maps else "")
        + ("_trained" if args.scene else "")
    )
    num_isects, cap_of, span_tr, tile_of, tight_cl = map(
        int, aux_fn(params, camera))
    from mojosplat_jax.utils.profiling import roofline_report

    rep = roofline_report(
        step_ms=dt * 1e3,
        n_pixels=args.height * args.width,
        n_isects=num_isects,
        n_gaussians=args.gaussians,
        sh_bases=(args.sh_degree + 1) ** 2 if sh is not None else 1,
        backward=args.mode == "fwdbwd",
        device_kind=dev.device_kind,
        tile_size=args.tile_size,
    )
    # Tight-culled slots are provably zero-contribution, so they are not
    # part of the demanded work (the kernels would zero them).
    demanded = num_isects + cap_of + span_tr
    print(json.dumps({
        "metric": metric,
        "value": args.height * args.width / dt,
        "unit": "pixels/s",
        "impl": args.impl,
        "step_ms": dt * 1e3,
        "step_ms_all": [t * 1e3 for t in times],
        "compile_s": compile_s,
        "num_isects": num_isects,
        "capacity_overflow": cap_of,
        "span_truncated": span_tr,
        "tile_overflow": tile_of,
        "tight_culled": tight_cl,
        "tile_size": args.tile_size,
        "isect_keep_fraction": num_isects / max(demanded, 1),
        "light_speed_ms": rep.light_speed_ms,
        "fraction_of_light": rep.fraction_of_light,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": gpu_name_and_power_limit(),
    }))


if __name__ == "__main__":
    main()
