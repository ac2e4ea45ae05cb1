"""Per-view exposure-compensation tests (train.apply_exposure)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from mojosplat_jax import train as mtrain


def test_identity_exposure_is_noop():
    img = jax.random.uniform(jax.random.PRNGKey(0), (16, 20, 3))
    out = mtrain.apply_exposure(img, mtrain.identity_exposure(1)[0])
    np.testing.assert_allclose(np.asarray(out), np.asarray(img), atol=1e-7)


def test_exposure_matches_affine_formula():
    rng = np.random.default_rng(1)
    img = jnp.asarray(rng.uniform(0, 1, (8, 9, 3)).astype(np.float32))
    A = jnp.asarray(rng.normal(0, 0.3, (3, 4)).astype(np.float32))
    out = mtrain.apply_exposure(img, A)
    ref = np.asarray(img) @ np.asarray(A[:, :3]).T + np.asarray(A[:, 3])
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)


def test_exposure_recovery():
    # target = true_affine(img); optimizing the affine alone must recover it.
    rng = np.random.default_rng(2)
    img = jnp.asarray(rng.uniform(0, 1, (32, 32, 3)).astype(np.float32))
    true = mtrain.identity_exposure(1)[0] + jnp.asarray(
        rng.normal(0, 0.1, (3, 4)).astype(np.float32)
    )
    target = mtrain.apply_exposure(img, true)

    def loss(a):
        return jnp.mean((mtrain.apply_exposure(img, a) - target) ** 2)

    opt = optax.adam(3e-2)
    a = mtrain.identity_exposure(1)[0]
    s = opt.init(a)

    @jax.jit
    def step(a, s):
        g = jax.grad(loss)(a)
        u, s = opt.update(g, s, a)
        return optax.apply_updates(a, u), s

    for _ in range(400):
        a, s = step(a, s)
    np.testing.assert_allclose(np.asarray(a), np.asarray(true), atol=2e-2)
