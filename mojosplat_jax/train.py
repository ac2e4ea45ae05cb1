"""Trainable gaussian-splatting: parameter pytree, loss, sharded train step.

The reference has no training loop at all (forward-only @torch.no_grad(),
/root/reference/mojosplat/render.py:11; no optimizer, no checkpointing —
SURVEY.md section 5). This module provides the training-step capability the
BASELINE north star requires: differentiable render -> L2 loss -> optax
updates, single-device or sharded over a ('data', 'tile') mesh with gradients
psum'd over NVLink (NCCL).

Parameterization (standard 3DGS): raw (pre-activation) opacities stored as
logits (the demo applies sigmoid, render_sample.py:99); scales stay in log
space end-to-end; quaternions are normalized inside projection.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from .camera import Camera
from .config import DEFAULT_CONFIG, RenderConfig
from .ops.sh import num_sh_bases
from .parallel.sharding import check_slab_divisibility, render_slabs, shard_map
from .render import render_gaussians


class TrainState(NamedTuple):
    params: dict[str, Any]
    opt_state: Any
    step: jax.Array


def init_gaussians(
    key: jax.Array,
    n: int,
    sh_degree: int | None = None,
    position_scale: float = 2.0,
    log_scale_mean: float = -2.0,
) -> dict[str, Any]:
    """Random gaussian cloud, same distribution as the reference demo
    (/root/reference/render_sample.py:86-109): randn*2 means, log-scales
    around -2, random unit quats, sigmoid-distributed opacities."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    quats = jax.random.normal(k3, (n, 4))
    quats /= jnp.linalg.norm(quats, axis=-1, keepdims=True)
    if sh_degree is None:
        features = jax.random.uniform(k5, (n, 3))
    else:
        K = num_sh_bases(sh_degree)
        features = jnp.zeros((n, K, 3)).at[:, 0, :].set(
            jax.random.uniform(k5, (n, 3)) - 0.5
        )
    return dict(
        means3d=jax.random.normal(k1, (n, 3)) * position_scale,
        scales=log_scale_mean + jax.random.normal(k2, (n, 3)) * 0.3,
        quats=quats,
        opacities_raw=jax.random.normal(k4, (n,)) + 1.0,  # logits
        features=features,
    )


def activate(params: dict[str, Any]) -> dict[str, Any]:
    """Raw (trainable) params -> render params (sigmoid on opacities)."""
    out = dict(params)
    out["opacities"] = jax.nn.sigmoid(out.pop("opacities_raw"))
    return out


def l2_image_loss(rendered: jax.Array, target: jax.Array) -> jax.Array:
    return jnp.mean((rendered - target) ** 2)


def psnr(a: jax.Array, b: jax.Array) -> jax.Array:
    """Peak signal-to-noise ratio in dB for [0, 1] images (eps-guarded so a
    perfect fit reports ~120 dB instead of inf)."""
    return -10.0 * jnp.log10(jnp.mean((a - b) ** 2) + 1e-12)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> jax.Array:
    x = jnp.arange(size, dtype=jnp.float32) - (size - 1) / 2.0
    g = jnp.exp(-(x**2) / (2.0 * sigma**2))
    g = g / jnp.sum(g)
    return g[:, None] * g[None, :]


def ssim(a: jax.Array, b: jax.Array, window_size: int = 11) -> jax.Array:
    """Mean SSIM between two (..., H, W, C) images in [0, 1].

    The 11x11 Gaussian-window SSIM of the original 3DGS training recipe
    (which the reference cannot run — it has no training). Implemented as
    depthwise convolutions so XLA maps it onto the cuDNN convolutions.
    """
    c1, c2 = 0.01**2, 0.03**2
    w = _gaussian_window(window_size)

    lead = a.shape[:-3]
    H, W, C = a.shape[-3:]
    x = a.reshape((-1, H, W, C)).transpose(0, 3, 1, 2).reshape(-1, 1, H, W)
    y = b.reshape((-1, H, W, C)).transpose(0, 3, 1, 2).reshape(-1, 1, H, W)
    kernel = w[None, None, :, :]

    def blur(img):
        # HIGHEST precision is load-bearing: a float32 conv may otherwise
        # run in TF32 on the GPU (10-bit mantissa), and the variance
        # estimate blur(x^2) - mx^2 then carries ~0.1%-of-mx^2
        # cancellation error — comparable to c2 = 9e-4 on smooth/constant
        # regions, where the denominator (sx + sy + c2) goes tiny or
        # negative and SSIM explodes past 1 (seen with bf16 inputs: mean
        # SSIM 1.71 on a flat-background scene, a negative training loss
        # and NaN gradients).
        return jax.lax.conv_general_dilated(
            img, kernel, (1, 1), "SAME",
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            precision=jax.lax.Precision.HIGHEST,
        )

    mx, my = blur(x), blur(y)
    mxx, myy, mxy = mx * mx, my * my, mx * my
    sx = blur(x * x) - mxx
    sy = blur(y * y) - myy
    sxy = blur(x * y) - mxy
    s = ((2 * mxy + c1) * (2 * sxy + c2)) / (
        (mxx + myy + c1) * (sx + sy + c2)
    )
    return jnp.mean(s.reshape(lead + (-1,)) if lead else s)


def dssim_l1_loss(
    rendered: jax.Array, target: jax.Array, ssim_weight: float = 0.2
) -> jax.Array:
    """The standard 3DGS photometric loss:
    (1 - w) * L1 + w * (1 - SSIM)."""
    l1 = jnp.mean(jnp.abs(rendered - target))
    return (1.0 - ssim_weight) * l1 + ssim_weight * (1.0 - ssim(
        rendered, target
    ))


def make_optimizer(lr: float = 1e-2) -> optax.GradientTransformation:
    return optax.adam(lr)


def selective_adam(
    learning_rate: float = 1e-2,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> optax.GradientTransformation:
    """Adam that freezes rows whose gradient is exactly zero this step.

    The per-gaussian analogue of gsplat's ``selective_adam``: a gaussian
    culled or binned outside every rendered tile receives an exactly-zero
    gradient (culling is jnp.where-masked, binning is stop_gradient'ed), yet
    plain Adam still decays its moments and applies a drift update
    m/(sqrt(v)+eps) from stale moments. Here rows with all-zero gradients
    keep their moments AND parameters untouched — matching single-GPU 3DGS
    trainers that only step visible gaussians. Leading-axis rows are
    detected per leaf, so (N,), (N,3) and (N,K,3) parameters all work.
    """
    adam = optax.adam(learning_rate, b1=b1, b2=b2, eps=eps)

    def init(params):
        return adam.init(params)

    def update(grads, state, params=None):
        visible = jax.tree_util.tree_map(
            lambda g: jnp.any(
                g != 0, axis=tuple(range(1, g.ndim)), keepdims=False
            ),
            grads,
        )

        def rowmask(v, like):
            return v.reshape(v.shape + (1,) * (like.ndim - 1))

        updates, new_state = adam.update(grads, state, params)
        updates = jax.tree_util.tree_map(
            lambda u, v: jnp.where(rowmask(v, u), u, 0.0), updates, visible
        )
        # Freeze first/second moments of invisible rows (count still
        # advances globally, as in the CUDA implementation).
        # optax.adam state = (ScaleByAdamState(count, mu, nu), EmptyState());
        # mask mu/nu per leaf against the matching visibility leaf.
        sba_new, rest = new_state
        sba_old, _ = state
        mu = jax.tree_util.tree_map(
            lambda n, o, v: jnp.where(rowmask(v, n), n, o),
            sba_new.mu, sba_old.mu, visible,
        )
        nu = jax.tree_util.tree_map(
            lambda n, o, v: jnp.where(rowmask(v, n), n, o),
            sba_new.nu, sba_old.nu, visible,
        )
        new_state = (sba_new._replace(mu=mu, nu=nu), rest)
        return updates, new_state

    return optax.GradientTransformation(init, update)


def init_train_state(params, optimizer) -> TrainState:
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=jnp.zeros((), jnp.int32),
    )


def train_step(
    state: TrainState,
    cameras: Camera,  # batched over leading axis B
    targets: jax.Array,  # (B, H, W, C)
    optimizer: optax.GradientTransformation,
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    loss_extra=None,
) -> tuple[TrainState, jax.Array]:
    """Single-device training step over a batch of views.

    ``loss_extra(raw_params) -> scalar`` adds a parameter regularizer to the
    image loss (e.g. densify.mcmc_regularization).
    """

    def loss_fn(params):
        def render_one(cam):
            p = activate(params)
            return render_gaussians(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, sh_degree=sh_degree, config=config,
            )

        imgs = jax.vmap(render_one)(cameras)
        loss = l2_image_loss(imgs, targets)
        if loss_extra is not None:
            loss = loss + loss_extra(params)
        return loss

    loss, grads = jax.value_and_grad(loss_fn)(state.params)
    updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params, opt_state, state.step + 1), loss


def train_step_with_densify_stats(
    state: TrainState,
    densify_state,
    cameras: Camera,  # batched over leading axis B
    targets: jax.Array,  # (B, H, W, C)
    optimizer: optax.GradientTransformation,
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    absgrad: bool = False,
):
    """Training step that also accumulates view-space gradient statistics
    for adaptive density control (densify.py). Returns
    (new TrainState, new DensifyState, loss).

    ``absgrad=True`` accumulates the ABSOLUTE per-tile view-space gradient
    (AbsGS / gsplat absgrad; both raster routes serve it through the
    per-slot tap ops/rasterization._abs_tap) instead of the
    signed sum — opposite-sided tile contributions no longer cancel, so
    large under-reconstructed gaussians densify reliably. Use a roughly 2-4x
    higher DensifyConfig.grad_threshold with it (gsplat's examples use 8e-4
    absgrad vs 2e-4 signed).
    """
    from .densify import accumulate_stats
    from .ops.projection import project_gaussians

    n = state.params["means3d"].shape[0]

    def loss_fn(params, offset):
        def render_one(cam):
            p = activate(params)
            sink = {"absgrad_sink" if absgrad else "means2d_offset": offset}
            return render_gaussians(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, sh_degree=sh_degree, config=config,
                **sink,
            )

        imgs = jax.vmap(render_one)(cameras)
        return l2_image_loss(imgs, targets)

    offset0 = jnp.zeros((n, 2), jnp.float32)
    loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        state.params, offset0
    )
    param_grads, view_grads = grads

    # Visibility: rendered by at least one camera this step.
    def vis_one(cam):
        p = activate(state.params)
        proj = project_gaussians(
            p["means3d"], p["scales"], p["quats"], p["opacities"], cam,
            config,
        )
        return proj.radii[:, 0] > 0

    visible = jnp.any(jax.vmap(vis_one)(cameras), axis=0)
    densify_state = accumulate_stats(densify_state, view_grads, visible)

    updates, opt_state = optimizer.update(
        param_grads, state.opt_state, state.params
    )
    params = optax.apply_updates(state.params, updates)
    return (
        TrainState(params, opt_state, state.step + 1),
        densify_state,
        loss,
    )


def _zero1_rows(tree, di, n_dev):
    """Slice every leaf's leading (gaussian) axis to device di's rows."""
    def rows(x):
        m = x.shape[0] // n_dev
        return jax.lax.dynamic_slice_in_dim(x, di * m, m, 0)

    return jax.tree_util.tree_map(rows, tree)


def _zero1_apply(params, grads, opt_state, optimizer, n_tile, n_dev):
    """ZeRO-1 update inside shard_map: slice-step this device's gaussian
    rows (its moment slices arrived pre-sharded), all_gather the updated
    slices back to replicated params. Row-wise optimizers make this exactly
    the replicated update."""
    di = jax.lax.axis_index("data") * n_tile + jax.lax.axis_index("tile")
    g_loc = _zero1_rows(grads, di, n_dev)
    p_loc = _zero1_rows(params, di, n_dev)
    updates, opt_state = optimizer.update(g_loc, opt_state, p_loc)
    p_loc = optax.apply_updates(p_loc, updates)
    params = jax.tree_util.tree_map(
        lambda x: jax.lax.all_gather(
            x, ("data", "tile"), axis=0, tiled=True
        ),
        p_loc,
    )
    return params, opt_state


def _zero1_os_spec(opt_state):
    """Per-leaf PartitionSpecs sharding moment arrays' leading axis over
    the whole mesh; scalars (Adam's count) stay replicated."""
    return jax.tree_util.tree_map(
        lambda x: (P(("data", "tile"))
                   if getattr(x, "ndim", 0) >= 1 else P()),
        opt_state,
    )


def train_step_sharded(
    state: TrainState,
    cameras: Camera,  # batched over leading axis B (sharded over 'data')
    targets: jax.Array,  # (B, H, W, C) (sharded over 'data' and rows-'tile')
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    loss_extra=None,
    zero1: bool = False,
) -> tuple[TrainState, jax.Array]:
    """Training step sharded over a ('data', 'tile') mesh.

    Each device renders its camera shard's tile-row slab and computes the
    local loss contribution; per-gaussian parameter gradients are psum'd over
    both axes (the overlapped grad all-reduce of BASELINE config 5), so every
    device applies identical optimizer updates to the replicated parameters.

    ``loss_extra(raw_params) -> scalar`` adds a parameter regularizer (e.g.
    densify.mcmc_regularization); params are replicated, so it is evaluated
    per device and NOT reduced over the mesh.

    ``zero1=True`` shards the OPTIMIZER STATE over all mesh devices
    (ZeRO-1): after the gradient psum each device Adam-steps only its
    1/n_dev slice of the gaussian axis (the moments for that slice live on
    it alone), and the updated slices are all-gathered back to replicated
    params. Cuts the moments' per-device memory by n_dev for one
    parameter-sized all_gather per step; numerically identical to the
    replicated update (tests/test_sharding.py). Requires N divisible by
    n_dev. Initialize opt_state with init_train_state as usual — the
    moments are stored at full logical shape and the mesh shards them
    physically.
    """
    slab_h = check_slab_divisibility(cameras.H, mesh.shape["tile"], config)
    n_tile = mesh.shape["tile"]
    n_dev = mesh.shape["data"] * n_tile
    if zero1 and state.params["opacities_raw"].shape[0] % n_dev != 0:
        raise ValueError(
            f"zero1 needs N ({state.params['opacities_raw'].shape[0]}) "
            f"divisible by the device count ({n_dev})"
        )

    def shard_fn(params, opt_state, step, cams, tgts):
        def loss_fn(p):
            imgs = render_slabs(
                activate(p), cams, slab_h, sh_degree, None, config
            )
            # Mean over the *global* batch: local sum / global count.
            local = jnp.sum((imgs - tgts) ** 2)
            return local

        local_loss, grads = jax.value_and_grad(loss_fn)(params)
        # Sum-of-squares and grads reduce over both mesh axes (NCCL psum).
        loss = jax.lax.psum(local_loss, ("data", "tile"))
        grads = jax.lax.psum(grads, ("data", "tile"))
        denom = jnp.asarray(
            tgts.size * n_dev, dtype=local_loss.dtype
        )  # global element count
        loss = loss / denom
        grads = jax.tree_util.tree_map(lambda g: g / denom, grads)
        if loss_extra is not None:
            # Params are replicated: every device computes the identical
            # regularizer and gradient, so no mesh reduction is needed.
            reg, reg_grads = jax.value_and_grad(loss_extra)(params)
            loss = loss + reg
            grads = jax.tree_util.tree_map(
                lambda g, r: g + r, grads, reg_grads
            )
        if zero1:
            params, opt_state = _zero1_apply(
                params, grads, opt_state, optimizer, n_tile, n_dev
            )
        else:
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        return params, opt_state, step + 1, loss

    os_spec = _zero1_os_spec(state.opt_state) if zero1 else P()

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), os_spec, P(), P("data"), P("data", "tile")),
        out_specs=(P(), os_spec, P(), P()),
        check_vma=False,
    )
    params, opt_state, step, loss = fn(
        state.params, state.opt_state, state.step, cameras, targets
    )
    return TrainState(params, opt_state, step), loss


def train_step_sharded_surfel(
    state: TrainState,
    cameras: Camera,  # batched over leading axis B (sharded over 'data')
    targets: jax.Array,  # (B, H, W, 3) (sharded over 'data' and rows-'tile')
    optimizer: optax.GradientTransformation,
    mesh: Mesh,
    sh_degree: int | None = None,
    config: RenderConfig = DEFAULT_CONFIG,
    normal_weight: float = 0.0,
    distortion_weight: float = 0.0,
    zero1: bool = False,
) -> tuple[TrainState, jax.Array]:
    """2DGS (surfel) training step sharded over a ('data', 'tile') mesh,
    with the paper's depth-distortion and normal-consistency regularizers
    computed per tile-row slab and reduced over the mesh.

    Each device renders its camera shard's slab WITH the per-pixel maps
    (both raster impls serve them — the surfel Pallas aux kernels blend the
    depth moments and normals in the same pass), computes local loss terms,
    and psums them inside the differentiated function, so the quotient rule
    of the normal-consistency ratio (psum num / psum den) is handled by AD;
    parameter gradients are then psum'd and identical optax updates applied
    to the replicated parameters. ``zero1``: shard the optimizer state over
    the mesh (see train_step_sharded).
    """
    from .surfel import (
        expected_depth_map,
        normal_consistency_terms,
        render_surfels,
    )

    slab_h = check_slab_divisibility(cameras.H, mesh.shape["tile"], config)
    n_tile = mesh.shape["tile"]
    # ``targets`` here is the global batch (shard_map slices it), so its
    # size is already the global element count.
    npix_global = targets.size

    def shard_fn(params, opt_state, step, cams, tgts):
        ti = jax.lax.axis_index("tile")
        row0 = ti * slab_h

        def loss_fn(raw):
            p = activate(raw)

            def one(cam, tgt):
                img, depth, normal, dist, aux = render_surfels(
                    p["means3d"], p["scales"], p["quats"], p["opacities"],
                    p["features"], cam, sh_degree=sh_degree, config=config,
                    return_aux=True, return_depth=True, return_normals=True,
                    return_distortion=True, viewport_rows=(row0, slab_h),
                )
                # Halo exchange: the normal-consistency stencil (y finite
                # differences on the expected depth) needs one row of
                # context from the neighboring slabs; one ppermute up + one
                # down over NVLink (NCCL) makes the sharded regularizer exactly equal
                # to the single-device one. Global edges use the reflective
                # ghosts backproject_normals_from_depth synthesizes.
                ed, _ = expected_depth_map(
                    depth, aux.raster.final_transmittance
                )
                ed = jax.lax.stop_gradient(ed)
                recv_top = jax.lax.ppermute(
                    ed[-1], "tile",
                    [(i, i + 1) for i in range(n_tile - 1)],
                )
                recv_bot = jax.lax.ppermute(
                    ed[0], "tile",
                    [(i + 1, i) for i in range(n_tile - 1)],
                )
                ghost_top = jnp.where(
                    ti == 0, 2.0 * ed[0] - ed[1], recv_top
                )
                ghost_bot = jnp.where(
                    ti == n_tile - 1, 2.0 * ed[-1] - ed[-2], recv_bot
                )
                nc_num, nc_den = normal_consistency_terms(
                    depth, normal, aux.raster.final_transmittance, cam,
                    row0=row0, ghost_rows=(ghost_top, ghost_bot),
                )
                return (
                    jnp.sum((img - tgt) ** 2),
                    jnp.sum(dist),
                    nc_num,
                    nc_den,
                )

            photo, dist, nc_num, nc_den = jax.tree_util.tree_map(
                jnp.sum, jax.vmap(one)(cams, tgts)
            )
            # Global reductions INSIDE the loss: AD differentiates through
            # psum (its transpose broadcasts cotangents), so the ratio term
            # gets the correct quotient-rule gradient across devices.
            photo = jax.lax.psum(photo, ("data", "tile"))
            dist = jax.lax.psum(dist, ("data", "tile"))
            nc_num = jax.lax.psum(nc_num, ("data", "tile"))
            nc_den = jax.lax.psum(nc_den, ("data", "tile"))
            loss = photo / npix_global
            if distortion_weight:
                # Mean distortion over global pixels (B * H * W).
                loss = loss + distortion_weight * dist / (npix_global // 3)
            if normal_weight:
                loss = loss + normal_weight * nc_num / jnp.maximum(
                    nc_den, 1.0
                )
            return loss

        loss, grads = jax.value_and_grad(loss_fn)(params)
        # loss is already global; grads hold each device's local
        # contribution to the replicated parameters.
        grads = jax.lax.psum(grads, ("data", "tile"))
        if zero1:
            params, opt_state = _zero1_apply(
                params, grads, opt_state, optimizer, n_tile,
                n_tile * mesh.shape["data"],
            )
        else:
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        return params, opt_state, step + 1, loss

    os_spec = _zero1_os_spec(state.opt_state) if zero1 else P()
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), os_spec, P(), P("data"), P("data", "tile")),
        out_specs=(P(), os_spec, P(), P()),
        check_vma=False,
    )
    params, opt_state, step, loss = fn(
        state.params, state.opt_state, state.step, cameras, targets
    )
    return TrainState(params, opt_state, step), loss


def sparse_depth_loss(
    depth: jax.Array,  # (H, W) accumulated (alpha-weighted) depth
    alpha: jax.Array,  # (H, W) accumulated opacity = 1 - final transmittance
    uv: jax.Array,  # (K, 2) pixel coords of SfM observations
    depth_gt: jax.Array,  # (K,) camera-frame z of the triangulated points
    mask: jax.Array,  # (K,) bool, valid targets
    eps: float = 1e-6,
) -> jax.Array:
    """L1 disparity loss at sparse SfM keypoints — the depth-supervised
    training mode of contemporary 3DGS trainers (gsplat's depth_loss):
    anchor the rendered geometry to the COLMAP triangulation so floaters
    collapse and scale stays metric. Targets come from
    utils.colmap.sparse_depth_targets.

    The rendered disparity is ``alpha / (depth + eps)`` — algebraically
    1/expected-depth, but smooth and select-free: uncovered pixels
    (alpha -> 0) contribute a bounded ``1/depth_gt`` error instead of a
    NaN/Inf (this repo's double-where lesson: sanitize with the algebra,
    not with selects).
    """
    H, W = depth.shape
    ix = jnp.clip(jnp.round(uv[:, 0]).astype(jnp.int32), 0, W - 1)
    iy = jnp.clip(jnp.round(uv[:, 1]).astype(jnp.int32), 0, H - 1)
    flat = iy * W + ix
    d = jnp.take(depth.reshape(-1), flat)
    a = jnp.take(alpha.reshape(-1), flat)
    disp = a / (d + eps)
    err = jnp.abs(disp - 1.0 / jnp.maximum(depth_gt, eps))
    m = mask.astype(depth.dtype)
    return jnp.sum(err * m) / jnp.maximum(jnp.sum(m), 1.0)


def apply_exposure(image: jax.Array, affine: jax.Array) -> jax.Array:
    """Per-view affine color correction: (H, W, 3) image, (3, 4) affine
    [A | b] -> image @ A^T + b.

    The exposure-compensation module for real captures with auto-exposure /
    white-balance drift (the appearance-optimization capability of
    contemporary 3DGS trainers): the correction absorbs per-view photometric
    nuisance so the scene's SH colors converge to a consistent radiance.
    Initialize to identity (train_colmap --exposure-opt optimizes per-view
    matrices with selective Adam); at evaluation, render WITHOUT the
    correction (or with the held-out view's identity) so metrics measure
    the scene, not the nuisance fit.
    """
    return jnp.einsum(
        "hwc,dc->hwd", image, affine[:, :3], precision="highest"
    ) + affine[:, 3]


def identity_exposure(n_views: int) -> jax.Array:
    """(V, 3, 4) identity affines [I | 0] for apply_exposure."""
    return jnp.tile(
        jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1),
        (n_views, 1, 1),
    )
