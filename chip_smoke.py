"""Smoke run of the renderer and trainer on one NVIDIA GPU.

    python chip_smoke.py               # one card: all phases below
    python chip_smoke.py --four-cards  # four cards: the sharded train steps

Phases (one card), each of which must pass:

1. Device: JAX's first device must be a GPU (there is no CPU fallback);
   prints its kind, the device count and nvidia-smi's name and power limit.
2. Render: the committed trained scene (1M gaussians, SH3) at 1920x1080
   with bench.py's preset-6 configuration; the image must be finite. Prints
   the binning counters and the keep fraction.
3. Train: five ``train.train_step`` Adam steps at that size, from slightly
   perturbed parameters towards a view rendered from the unperturbed scene.
   Every loss must be finite and the last below the first. Prints the
   step's ``memory_analysis()`` and the device's peak bytes in use.
4. Parity with the plain reference, the XLA route under
   ``jax.default_matmul_precision("highest")``: image and every parameter
   gradient at preset 3's size (100k gaussians, 800x600), and the forward
   image of the 1080p trained scene. Prints each error beside its tolerance.
5. The tests marked ``chip``, run in this process.

``--four-cards`` runs only ``train_step_sharded`` on a (data=2, tile=2)
mesh and ``train_step_gauss_sharded`` on a 4-device 'gauss' mesh, each
compared with the single-device ``train_step`` on the same cameras.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

import bench
from mojosplat_jax import RenderConfig, render_gaussians
from mojosplat_jax import train as mtrain
from mojosplat_jax.utils.compress import load_compressed_scene
from mojosplat_jax.utils.runtime import (
    enable_compile_cache,
    gpu_name_and_power_limit,
    require_gpu,
)

SCENE = "assets/trained_scene_1m.npz"
BG = (0.1, 0.1, 0.1)

# Tolerances of the kernel route against the reference, and why they hold.
# Image values lie in [0, 1]. The kernel forms each chunk's transmittance
# prefix as exp(cumsum(log1p(-alpha))) where the reference multiplies, and
# sums in another order: a few float32 ulps per chunk (~1e-6 relative), plus
# float32 exp differing between the two code generators. The one place an
# ulp can move a result is the early-termination test T > 1e-4: a pixel at
# that boundary may blend one gaussian more or less, whose weight is below
# 1e-4. Hence 2e-4 absolute on images.
IMAGE_ATOL = 2e-4
# Gradients, as max |kernel - reference| / max |reference| per parameter:
# the same reordering, the per-slot rows summed by a scatter-add whose
# atomic order changes from run to run, and the boundary flips above, which
# change one pixel's gradient by a term of weight <= 1e-4.
GRAD_RTOL = 2e-3
# Sharded steps against the single-device step, as max |difference| / max
# |single| of each parameter's gradient: psum and all_to_all sum per-device
# partial gradients in another order than the single-device scatter-add.
SHARD_RTOL = 2e-3


def log(*a):
    print(*a, flush=True)


def phase(name):
    log(f"== {name}")
    return time.perf_counter()


def render_fn(config, sh_degree):
    def f(p, cam):
        return render_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"],
            p["features"], cam, sh_degree=sh_degree,
            background_color=jnp.array(BG), config=config, return_aux=True,
        )
    return f


def preset_config(n, impl="pallas"):
    pr = bench.PRESETS[n]
    return RenderConfig(
        tile_size=pr["tile_size"], tile_capacity=pr["tile_capacity"],
        chunk_size=64, tile_batch=512, max_tile_span=pr["span"],
        isect_padding_multiplier=pr["capacity_mult"],
        tight_cull=pr.get("tight_cull", False), raster_impl=impl,
    )


def batch1(cam):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x)[None], cam)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def check(name, err, tol):
    ok = bool(np.isfinite(err) and err <= tol)
    log(f"  {name}: max err {err:.3e} tol {tol:.1e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"parity failed: {name}")


def perturbed(raw, seed=0):
    """Raw parameters nudged off the trained optimum."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    out = dict(raw)
    out["means3d"] = raw["means3d"] + 3e-3 * jax.random.normal(
        keys[0], raw["means3d"].shape)
    out["features"] = raw["features"] + 2e-2 * jax.random.normal(
        keys[1], raw["features"].shape)
    out["opacities_raw"] = raw["opacities_raw"] + 0.1 * jax.random.normal(
        keys[2], raw["opacities_raw"].shape)
    return out


def load_raw():
    return {k: jnp.asarray(v) for k, v in load_compressed_scene(SCENE).items()}


def phase_render(cfg, H, W):
    t = phase("render: trained scene 1M SH3 1920x1080, preset 6")
    params = mtrain.activate(load_raw())
    cam = bench.scene_camera(H, W)
    img, aux = jax.jit(render_fn(cfg, 3))(params, cam)
    img = np.asarray(img)
    b = aux.binning
    n, cap_of, span_tr, tight = (int(b.num_isects), int(b.capacity_overflow),
                                 int(b.span_truncated), int(b.tight_culled))
    tile_of = int(aux.raster.tile_overflow)
    demanded = max(n + cap_of + span_tr, 1)
    log(f"  image {img.shape} finite={bool(np.isfinite(img).all())} "
        f"mean={img.mean():.6f}")
    # isect_keep_fraction is bench.py's: slots binned of those demanded.
    # blend_fraction also takes off the slots tile_capacity drops.
    log(f"  num_isects={n} capacity_overflow={cap_of} span_truncated="
        f"{span_tr} tile_overflow={tile_of} tight_culled={tight} "
        f"isect_keep_fraction={n / demanded:.6f} "
        f"blend_fraction={(n - tile_of) / demanded:.6f}")
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise SystemExit("render produced a non-finite or misshapen image")
    log(f"  {time.perf_counter() - t:.1f} s")


def phase_train(cfg, H, W, steps=5):
    t = phase(f"train: {steps} train_step Adam steps, 1M SH3 {W}x{H}")
    raw = load_raw()
    cam = bench.scene_camera(H, W)
    target = jax.jit(render_fn(cfg, 3))(mtrain.activate(raw), cam)[0]
    opt = mtrain.make_optimizer(1e-3)
    state = mtrain.init_train_state(perturbed(raw), opt)
    del raw

    def step(s, cams, tgts):
        return mtrain.train_step(s, cams, tgts, opt, sh_degree=3, config=cfg)

    cams, tgts = batch1(cam), target[None]
    compiled = jax.jit(step, donate_argnums=0).lower(
        state, cams, tgts).compile()
    log(f"  memory_analysis: {compiled.memory_analysis()}")
    losses = []
    for _ in range(steps):
        state, loss = compiled(state, cams, tgts)
        losses.append(float(loss))
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  losses {losses}")
    log(f"  peak_bytes_in_use={stats.get('peak_bytes_in_use')} "
        f"bytes_limit={stats.get('bytes_limit')}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise SystemExit("training losses are not finite and decreasing")
    log(f"  {time.perf_counter() - t:.1f} s")


def phase_parity(cfg6, H, W):
    t = phase("parity: pallas route vs XLA reference (highest precision)")
    cfg3 = preset_config(3)
    ref3 = dataclasses.replace(cfg3, raster_impl="xla")
    pr = bench.PRESETS[3]
    _, params3, cam3, _ = bench.build_step(
        pr["gaussians"], pr["height"], pr["width"], None, cfg3, "fwd")

    def loss_and_grads(cfg):
        f = render_fn(cfg, None)

        def loss(p):
            img = f(p, cam3)[0]
            return jnp.mean(img ** 2), img

        (_, img), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params3)
        return np.asarray(img), {k: np.asarray(v) for k, v in g.items()}

    img_k, g_k = loss_and_grads(cfg3)
    with jax.default_matmul_precision("highest"):
        img_r, g_r = loss_and_grads(ref3)
    log("  preset 3: 100k gaussians, 800x600, fwd+bwd")
    check("image", float(np.abs(img_k - img_r).max()), IMAGE_ATOL)
    for k in sorted(g_r):
        check(f"grad {k}", rel_err(g_k[k], g_r[k]), GRAD_RTOL)

    params = mtrain.activate(load_raw())
    cam = bench.scene_camera(H, W)
    img_k = np.asarray(jax.jit(render_fn(cfg6, 3))(params, cam)[0])
    with jax.default_matmul_precision("highest"):
        img_r = np.asarray(jax.jit(render_fn(
            dataclasses.replace(cfg6, raster_impl="xla"), 3))(params, cam)[0])
    log("  trained scene: 1M SH3, 1920x1080, forward")
    check("image", float(np.abs(img_k - img_r).max()), IMAGE_ATOL)
    log(f"  {time.perf_counter() - t:.1f} s")


def phase_chip_tests():
    t = phase("tests marked chip")
    import pytest

    # tests/conftest.py keeps the suite on the CPU unless told otherwise.
    os.environ["JAX_PLATFORMS"] = "cuda"
    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      "tests/"])
    if rc != 0:
        raise SystemExit(f"chip tests failed (pytest exit code {rc})")
    log(f"  {time.perf_counter() - t:.1f} s")


def step_grads(state):
    """The gradient a step under ``optax.trace(0.0)`` kept in its state."""
    return {k: np.asarray(v) for k, v in state.opt_state.trace.items()}


def phase_four_cards(cfg, H, W):
    """Sharded steps vs the single-device step: their losses and their
    gradients. The optimizer is ``optax.trace(0.0)``, whose state holds the
    step's gradient itself; a parameter update would round most of it away
    at float32 resolution, and Adam's first step is sign-like.

    A tile-row slab caps each gaussian's tile span within the box clipped
    to the slab, so under span truncation the ('data', 'tile') step keeps
    other slots than a full-frame render (1.1% of the loss on this scene
    at preset 6's span of 4). The comparison therefore runs at a span no
    gaussian of the scene reaches (its widest covers 37 tiles), without
    tight culling (which needs a span <= 8), and checks that no budget
    dropped a slot."""
    from mojosplat_jax.parallel.gauss_sharded import (
        make_gauss_mesh,
        train_step_gauss_sharded,
    )
    from mojosplat_jax.parallel.sharding import make_mesh

    if len(jax.devices()) != 4:
        raise SystemExit(f"--four-cards needs 4 GPUs, found "
                         f"{len(jax.devices())}")
    cfg = dataclasses.replace(cfg, max_tile_span=64, tight_cull=False,
                              tile_capacity=2048)
    opt = optax.trace(0.0)
    raw = perturbed(load_raw())
    state = mtrain.init_train_state(raw, opt)
    cam = bench.scene_camera(H, W)
    cam2 = bench.scene_camera(H, W)
    cam2 = dataclasses.replace(cam2, T=cam2.T + jnp.array([0.05, 0.0, 0.0]))
    cams = jax.tree_util.tree_map(
        lambda a, b: jnp.stack([jnp.asarray(a), jnp.asarray(b)]), cam, cam2)
    clean = mtrain.activate(load_raw())
    targets = []
    for c in (cam, cam2):
        img, aux = jax.jit(render_fn(cfg, 3))(clean, c)
        b = aux.binning
        drops = (int(b.capacity_overflow), int(b.span_truncated),
                 int(aux.raster.tile_overflow))
        log(f"  target: num_isects={int(b.num_isects)} capacity_overflow,"
            f" span_truncated, tile_overflow={drops}")
        if drops[:2] != (0, 0):
            raise SystemExit("the comparison config drops slots")
        targets.append(img)
    targets = jnp.stack(targets)
    del clean

    single = jax.jit(lambda s, c, t: mtrain.train_step(
        s, c, t, opt, sh_degree=3, config=cfg))

    t = phase("train_step_sharded: mesh (data=2, tile=2), 2 cameras")
    mesh = make_mesh(2, 2)
    s1, l1 = single(state, cams, targets)
    d1 = step_grads(s1)
    del s1
    s2, l2 = jax.jit(lambda s, c, t: mtrain.train_step_sharded(
        s, c, t, opt, mesh, sh_degree=3, config=cfg))(state, cams, targets)
    d2 = step_grads(s2)
    del s2
    check("loss", abs(float(l2) - float(l1)) / abs(float(l1)), SHARD_RTOL)
    for k in sorted(d1):
        check(f"grad {k}", rel_err(d2[k], d1[k]), SHARD_RTOL)
    log(f"  {time.perf_counter() - t:.1f} s")

    t = phase("train_step_gauss_sharded: mesh (gauss=4), 1 camera")
    gmesh = make_gauss_mesh(4)
    s1, l1 = single(state, batch1(cam), targets[:1])
    d1 = step_grads(s1)
    del s1
    sharding = jax.sharding.NamedSharding(
        gmesh, jax.sharding.PartitionSpec("gauss"))
    gstate = mtrain.init_train_state(
        jax.device_put(raw, sharding), opt)
    s2, l2 = jax.jit(lambda s, c, t: train_step_gauss_sharded(
        s, c, t, opt, gmesh, sh_degree=3, config=cfg))(
        gstate, cam, targets[0])
    d2 = step_grads(s2)
    check("loss", abs(float(l2) - float(l1)) / abs(float(l1)), SHARD_RTOL)
    for k in sorted(d1):
        check(f"grad {k}", rel_err(d2[k], d1[k]), SHARD_RTOL)
    log(f"  {time.perf_counter() - t:.1f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded train steps on 4 GPUs")
    args = ap.parse_args()

    phase("device")
    dev = require_gpu()
    log(f"  cache: {enable_compile_cache()}")
    log(f"  device_kind={dev.device_kind} count={len(jax.devices())}")
    log(f"  nvidia-smi: {gpu_name_and_power_limit()}")

    cfg6 = preset_config(6)
    H, W = bench.PRESETS[6]["height"], bench.PRESETS[6]["width"]
    if args.four_cards:
        # Height divisible by 4 slabs of whole 32-px tile rows.
        phase_four_cards(cfg6, 1024, W)
    else:
        phase_render(cfg6, H, W)
        phase_train(cfg6, H, W)
        phase_parity(cfg6, H, W)
        phase_chip_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
