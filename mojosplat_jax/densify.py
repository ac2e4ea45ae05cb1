"""Adaptive density control: clone / split / prune at fixed capacity.

Standard 3DGS training (INRIA) grows and shrinks the gaussian set during
optimization: under-reconstructed regions get gaussians cloned or split,
transparent ones are pruned. The reference has no training at all, so no
ADC either. Under XLA the naive design (resize N every few hundred steps)
would recompile the entire pipeline; instead the parameter arrays have a FIXED
capacity N and an implicit alive mask (pruned gaussians get opacity logit
DEAD_LOGIT, which sigmoids to ~0 and is culled by the alpha threshold in
projection — they cost binning slots of zero tiles only). Clone/split
candidates are written into dead slots with one deterministic sort-based
slot assignment; every shape is static, nothing ever recompiles.

Densification statistics follow the original recipe: accumulate the norm of
the view-space (means2d) positional gradient per gaussian between densify
steps; candidates are those with mean accumulated gradient above a
threshold, cloned if small (max linear scale below a fraction of the scene
extent) and split if large (children sampled along the parent's principal
axis, scales shrunk by split_scale_factor).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

DEAD_LOGIT = -15.0  # sigmoid(-15) ~ 3e-7, far below the 1/255 alpha cull


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 2e-4  # mean view-space grad norm to densify
    percent_dense: float = 0.01  # small/large split point vs scene extent
    min_opacity: float = 0.005  # prune below this post-sigmoid opacity
    split_scale_factor: float = 1.6  # children scales = parent / this
    max_new_fraction: float = 0.25  # cap new gaussians per event


class DensifyState(NamedTuple):
    """Accumulated view-space gradient statistics between densify events."""

    grad_accum: jax.Array  # (N,) sum of ||d L / d means2d||
    count: jax.Array  # (N,) number of accumulation steps seen

    @staticmethod
    def zero(n: int) -> "DensifyState":
        return DensifyState(
            grad_accum=jnp.zeros((n,), jnp.float32),
            count=jnp.zeros((n,), jnp.int32),
        )


def alive_mask(params: dict[str, Any]) -> jax.Array:
    """(N,) bool: slots holding live gaussians."""
    return params["opacities_raw"] > DEAD_LOGIT + 1.0


def accumulate_stats(
    state: DensifyState, means2d_grad: jax.Array, visible: jax.Array
) -> DensifyState:
    """Add one step's view-space positional gradients.

    means2d_grad: (N, 2) dL/d means2d (e.g. the cotangent of a zero
    view-space offset parameter). visible: (N,) bool, gaussians that
    actually rendered this step (radii > 0).
    """
    norms = jnp.linalg.norm(means2d_grad, axis=-1)
    return DensifyState(
        grad_accum=state.grad_accum + jnp.where(visible, norms, 0.0),
        count=state.count + visible.astype(jnp.int32),
    )


def densify_and_prune(
    params: dict[str, Any],
    state: DensifyState,
    key: jax.Array,
    scene_extent: float | jax.Array,
    config: DensifyConfig = DensifyConfig(),
) -> tuple[dict[str, Any], DensifyState, dict[str, jax.Array]]:
    """One densification event at fixed capacity.

    Returns (new params with identical shapes, reset stats, metrics dict
    with cloned/split/pruned/alive counts). Fully jittable; deterministic
    given the PRNG key.
    """
    n = params["opacities_raw"].shape[0]
    alive = alive_mask(params)
    opac = jax.nn.sigmoid(params["opacities_raw"])

    # ---- prune: transparent gaussians release their slots.
    prune = alive & (opac < config.min_opacity)
    alive_after_prune = alive & ~prune

    # ---- candidates: high mean view-space gradient.
    mean_grad = state.grad_accum / jnp.maximum(state.count, 1)
    hot = alive_after_prune & (mean_grad > config.grad_threshold)
    max_scale = jnp.exp(jnp.max(params["scales"], axis=-1))
    small = max_scale <= config.percent_dense * scene_extent
    clone_c = hot & small
    split_c = hot & ~small

    # ---- slot budget: rank candidates by gradient, rank free slots, and
    # pair the i-th best candidate with the i-th free slot (one argsort
    # each; everything static).
    free = ~alive_after_prune
    n_free = jnp.sum(free)
    max_new = jnp.minimum(
        n_free, jnp.int32(config.max_new_fraction * n)
    )

    cand = clone_c | split_c
    order = jnp.argsort(jnp.where(cand, -mean_grad, jnp.inf))  # best first
    rank_of = jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.arange(n, dtype=jnp.int32)
    )
    n_cand = jnp.sum(cand)
    selected = cand & (rank_of < max_new)

    free_order = jnp.argsort(~free)  # free slots first, stable
    n_new = jnp.minimum(jnp.minimum(n_cand, max_new), n_free).astype(
        jnp.int32
    )
    # destination slot for the candidate with rank r is free_order[r].
    dest = free_order[jnp.clip(rank_of, 0, n - 1)]
    write = selected & (rank_of < n_new)

    # ---- child parameters.
    quats = params["quats"] / jnp.maximum(
        jnp.linalg.norm(params["quats"], axis=-1, keepdims=True), 1e-12
    )
    R = _quat_to_rotmat(quats)  # (N, 3, 3)
    scales_lin = jnp.exp(params["scales"])
    # Principal axis = column of R for the largest scale.
    main_axis = jnp.take_along_axis(
        R, jnp.argmax(params["scales"], axis=-1)[:, None, None], axis=2
    )[..., 0]
    sigma = jnp.max(scales_lin, axis=-1, keepdims=True)
    offset = (
        jax.random.normal(key, (n, 1)) * sigma * main_axis
    )  # sample along the principal axis

    is_split = split_c
    child_means = jnp.where(
        is_split[:, None], params["means3d"] + offset, params["means3d"]
    )
    child_scales = jnp.where(
        is_split[:, None],
        params["scales"] - jnp.log(config.split_scale_factor),
        params["scales"],
    )

    def place(dst, src):
        return dst.at[jnp.where(write, dest, n)].set(src, mode="drop")

    new_params = dict(params)
    new_params["means3d"] = place(params["means3d"], child_means)
    new_params["scales"] = place(params["scales"], child_scales)
    new_params["quats"] = place(params["quats"], params["quats"])
    new_params["opacities_raw"] = place(
        params["opacities_raw"], params["opacities_raw"]
    )
    new_params["features"] = place(params["features"], params["features"])

    # Split parents also shrink in place (the original replaces the parent
    # with two children; at fixed capacity the parent IS child one).
    shrink = is_split & write
    new_params["means3d"] = jnp.where(
        shrink[:, None],
        params["means3d"] - offset,
        new_params["means3d"],
    )
    new_params["scales"] = jnp.where(
        shrink[:, None], child_scales, new_params["scales"]
    )

    # Pruned slots die.
    new_params["opacities_raw"] = jnp.where(
        prune, DEAD_LOGIT, new_params["opacities_raw"]
    )

    metrics = dict(
        pruned=jnp.sum(prune),
        cloned=jnp.sum(write & clone_c),
        split=jnp.sum(write & split_c),
        alive=jnp.sum(alive_mask(new_params)),
    )
    return new_params, DensifyState.zero(n), metrics


def _quat_to_rotmat(q):
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)], -1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)], -1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)], -1),
        ],
        axis=1,
    )


def pad_to_capacity(params: dict[str, Any], capacity: int) -> dict[str, Any]:
    """Grow parameter arrays to ``capacity`` slots; new slots are dead."""
    n = params["opacities_raw"].shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < current N {n}")
    pad = capacity - n
    out = {}
    for k, v in params.items():
        padded = jnp.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
        out[k] = padded
    out["opacities_raw"] = out["opacities_raw"].at[n:].set(DEAD_LOGIT)
    # Identity quaternions, NOT zeros: the gradient of quat normalization at
    # exactly zero is NaN (0/0), and a NaN in a dead slot's parameters
    # poisons every later optimizer step that touches it (e.g. the MCMC
    # noise walk reads dead slots' rotations every step).
    out["quats"] = out["quats"].at[n:, 0].set(1.0)
    return out


# ---------------------------------------------------------------------------
# MCMC density control (3DGS-MCMC, Kheradmand et al. 2024): the second
# standard density-control family. Instead of grad-threshold clone/split,
# dead (transparent) gaussians are *relocated* onto alive ones sampled
# proportionally to opacity, with opacity/scale updated so the blended
# appearance of k coincident copies matches the original splat, and
# exploration comes from opacity-gated position noise plus L1 regularizers.
# A fixed-capacity formulation is the paper's own (it never grows beyond
# cap_max), which maps 1:1 onto this module's static-shape slot design.
# ---------------------------------------------------------------------------

_MCMC_N_MAX = 51  # max copies per relocation target (binomial table bound)


def _binomial_table(n_max: int) -> jnp.ndarray:
    import math

    tbl = [[math.comb(n, k) if k <= n else 0 for k in range(n_max + 1)]
           for n in range(n_max + 1)]
    return jnp.asarray(tbl, jnp.float32)


@dataclasses.dataclass(frozen=True)
class MCMCConfig:
    min_opacity: float = 0.005  # below this a slot is dead / relocatable
    noise_lr: float = 5e5  # position-noise scale multiplier
    noise_opacity_k: float = 100.0  # steepness of the noise opacity gate
    opacity_reg: float = 0.01  # L1 opacity regularizer weight
    scale_reg: float = 0.01  # L1 (linear-)scale regularizer weight


def relocation_update(
    opacities: jax.Array, ratio: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """New (opacity, scale coefficient) when 1 splat becomes ``ratio`` copies.

    Appearance-preserving update: k coincident copies of opacity o' blend to
    1-(1-o')^k, so o' = 1-(1-o)^(1/k) keeps the center alpha EXACT; the
    linear scales are multiplied by

        coeff = o / sum_{i=1..k} C(k,i) (-1)^(i+1) o'^i / sqrt(i)

    which keeps the 1D mass of the blended profile exact (expand
    1-(1-o'G(x))^k binomially; each term integrates to o'^i sqrt(2pi) s'/
    sqrt(i)), the derivation behind the paper's relocation equations.
    """
    ratio = jnp.clip(ratio.astype(jnp.int32), 1, _MCMC_N_MAX)
    o = opacities
    new_o = 1.0 - jnp.power(jnp.maximum(1.0 - o, 1e-12),
                            1.0 / ratio.astype(o.dtype))
    i = jnp.arange(1, _MCMC_N_MAX + 1, dtype=jnp.float32)  # (I,)
    binom = _binomial_table(_MCMC_N_MAX)[ratio]  # (N, I+1)
    terms = (
        binom[:, 1:]
        * jnp.power(new_o[:, None], i[None, :])
        * ((-1.0) ** (i[None, :] + 1.0))
        / jnp.sqrt(i[None, :])
    )
    mask = i[None, :] <= ratio[:, None].astype(jnp.float32)
    denom = jnp.sum(jnp.where(mask, terms, 0.0), axis=-1)
    coeff = o / jnp.maximum(denom, 1e-12)
    return new_o, coeff


def mcmc_relocate(
    params: dict[str, Any],
    key: jax.Array,
    config: MCMCConfig = MCMCConfig(),
) -> tuple[dict[str, Any], dict[str, jax.Array]]:
    """Relocate dead slots onto alive gaussians sampled by opacity.

    Every dead slot picks a target alive gaussian (probability proportional
    to opacity); the target and all copies landing on it share the
    relocation_update'd opacity/scales, so the rendered image is (to the
    paper's approximation) unchanged while dead capacity teleports to where
    opacity mass lives. All shapes static; one scatter-add at event rate.
    """
    n = params["opacities_raw"].shape[0]
    opac = jax.nn.sigmoid(params["opacities_raw"])
    alive = opac >= config.min_opacity
    dead = ~alive

    logits = jnp.where(alive, jnp.log(jnp.maximum(opac, 1e-12)), -jnp.inf)
    targets = jax.random.categorical(key, logits, shape=(n,))
    targets = jnp.where(dead, targets, jnp.arange(n, dtype=targets.dtype))

    # copies per target = itself + dead slots pointing at it.
    counts = (
        jnp.zeros((n,), jnp.int32)
        .at[jnp.where(dead, targets, n)]
        .add(1, mode="drop")
        + 1
    )
    any_alive = jnp.any(alive)
    ratio = jnp.where(any_alive, counts[targets], 1)

    new_o_t, coeff_t = relocation_update(opac[targets], ratio)
    take = lambda f: f[targets]  # noqa: E731

    new_params = dict(params)
    moved = dead & any_alive
    # any_alive gate: with zero alive gaussians, categorical over all -inf
    # logits still returns indices and counts>1 would mark those slots —
    # the event must be a strict no-op then.
    touched = moved | ((counts > 1) & any_alive)

    def sel(new, old):
        c = touched.reshape(touched.shape + (1,) * (new.ndim - 1))
        return jnp.where(c, new, old)
    new_params["means3d"] = sel(take(params["means3d"]), params["means3d"])
    new_params["quats"] = sel(take(params["quats"]), params["quats"])
    new_params["features"] = sel(take(params["features"]),
                                 params["features"])
    new_params["scales"] = sel(
        take(params["scales"]) + jnp.log(jnp.maximum(coeff_t, 1e-12))[:, None],
        params["scales"],
    )
    inv = jax.scipy.special.logit(jnp.clip(new_o_t, 1e-9, 1.0 - 1e-9))
    new_params["opacities_raw"] = sel(inv, params["opacities_raw"])

    metrics = dict(
        relocated=jnp.sum(moved),
        alive=jnp.sum(alive),
    )
    return new_params, metrics


def mcmc_position_noise(
    params: dict[str, Any],
    key: jax.Array,
    lr: float | jax.Array,
    config: MCMCConfig = MCMCConfig(),
) -> dict[str, Any]:
    """Opacity-gated covariance-shaped position noise (the paper's SGLD-style
    exploration term): means += lr * noise_lr * gate(o) * N(0, Sigma), where
    gate(o) = sigmoid(k * (min_opacity - o)) suppresses noise on opaque
    gaussians and Sigma = R S^2 R^T is each gaussian's own covariance."""
    n = params["opacities_raw"].shape[0]
    opac = jax.nn.sigmoid(params["opacities_raw"])
    gate = jax.nn.sigmoid(
        config.noise_opacity_k * (config.min_opacity - opac)
    )
    quats = params["quats"] / jnp.maximum(
        jnp.linalg.norm(params["quats"], axis=-1, keepdims=True), 1e-12
    )
    R = _quat_to_rotmat(quats)
    z = jax.random.normal(key, (n, 3))
    s = jnp.exp(params["scales"])
    if s.shape[-1] < 3:
        # Surfel (2DGS) parameterization: pad the missing thickness axis
        # with ~zero so exploration noise stays in the disk plane.
        s = jnp.pad(
            s, ((0, 0), (0, 3 - s.shape[-1])), constant_values=1e-6
        )
    sample = jnp.einsum("nij,nj->ni", R, s * z)  # ~ N(0, R S^2 R^T)
    step = jnp.asarray(lr) * config.noise_lr * gate
    out = dict(params)
    out["means3d"] = params["means3d"] + step[:, None] * sample
    return out


def mcmc_regularization(
    params: dict[str, Any], config: MCMCConfig = MCMCConfig()
) -> jax.Array:
    """L1 opacity + linear-scale regularizers (keep capacity churning)."""
    return config.opacity_reg * jnp.mean(
        jax.nn.sigmoid(params["opacities_raw"])
    ) + config.scale_reg * jnp.mean(jnp.abs(jnp.exp(params["scales"])))


def reset_opacities(
    params: dict[str, Any], max_opacity: float = 0.01
) -> dict[str, Any]:
    """INRIA training's periodic opacity reset (every ~3k steps): clamp all
    live opacities to at most ``max_opacity`` so the ADC prune step can
    reclaim splats that only survive on stale accumulated opacity. Dead
    slots (DEAD_LOGIT) are left dead."""
    logit = float(jnp.log(max_opacity / (1.0 - max_opacity)))
    raw = params["opacities_raw"]
    out = dict(params)
    out["opacities_raw"] = jnp.where(
        raw > DEAD_LOGIT + 1.0, jnp.minimum(raw, logit), raw
    )
    return out
