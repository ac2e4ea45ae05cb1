"""Spherical-harmonics evaluation tests (no reference analogue — SH is a
reference TODO, /root/reference/mojosplat/render.py:82-87)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mojosplat_jax.ops.sh import eval_sh, num_sh_bases, sh_to_color

C0 = 0.28209479177387814
C1 = 0.4886025119029199


def test_num_bases():
    assert [num_sh_bases(d) for d in range(4)] == [1, 4, 9, 16]


def test_degree0_is_direction_independent():
    sh = jnp.array([[[0.5, -0.2, 1.0]]])  # (1, 1, 3)
    a = eval_sh(sh, jnp.array([[0.0, 0.0, 1.0]]), 0)
    b = eval_sh(sh, jnp.array([[1.0, 0.0, 0.0]]), 0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)
    np.testing.assert_allclose(np.asarray(a[0]), C0 * np.array([0.5, -0.2, 1.0]),
                               rtol=1e-6)


def test_degree1_axis_values():
    # Band-1 basis at +z picks out coefficient 2 with weight +C1.
    sh = jnp.zeros((1, 4, 1)).at[0, 2, 0].set(1.0)
    v = eval_sh(sh, jnp.array([[0.0, 0.0, 1.0]]), 1)
    np.testing.assert_allclose(float(v[0, 0]), C1, rtol=1e-6)
    # At +y, coefficient 1 contributes -C1.
    sh = jnp.zeros((1, 4, 1)).at[0, 1, 0].set(1.0)
    v = eval_sh(sh, jnp.array([[0.0, 1.0, 0.0]]), 1)
    np.testing.assert_allclose(float(v[0, 0]), -C1, rtol=1e-6)


def test_direction_normalization():
    sh = jnp.ones((1, 16, 3))
    a = eval_sh(sh, jnp.array([[0.0, 0.0, 1.0]]), 3)
    b = eval_sh(sh, jnp.array([[0.0, 0.0, 42.0]]), 3)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_band_orthogonality_integrals(degree):
    # Monte-Carlo check: int_{S^2} Y_i Y_j ~ delta_ij / (4 pi normalization).
    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(20000, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    K = num_sh_bases(degree)
    basis = []
    for i in range(K):
        sh = np.zeros((1, K, 1), np.float64)
        sh[0, i, 0] = 1.0
        vals = eval_sh(
            jnp.asarray(np.broadcast_to(sh, (dirs.shape[0], K, 1))),
            jnp.asarray(dirs),
            degree,
        )
        basis.append(np.asarray(vals)[:, 0])
    B = np.stack(basis, 1)  # (M, K)
    gram = B.T @ B / dirs.shape[0] * 4 * math.pi
    np.testing.assert_allclose(gram, np.eye(K), atol=0.15)


def test_sh_to_color_offset_and_clamp():
    # +0.5 offset and clamp-at-0 (3DGS convention).
    sh = jnp.full((1, 1, 3), -10.0)
    c = sh_to_color(sh, jnp.array([[0.0, 0.0, 2.0]]), jnp.zeros(3), 0)
    np.testing.assert_allclose(np.asarray(c), 0.0, atol=1e-7)
    sh = jnp.zeros((1, 1, 3))
    c = sh_to_color(sh, jnp.array([[0.0, 0.0, 2.0]]), jnp.zeros(3), 0)
    np.testing.assert_allclose(np.asarray(c), 0.5, atol=1e-7)


def test_errors():
    with pytest.raises(ValueError):
        eval_sh(jnp.zeros((1, 4, 3)), jnp.zeros((1, 3)), 2)  # too few bases
    with pytest.raises(ValueError):
        eval_sh(jnp.zeros((1, 16, 3)), jnp.zeros((1, 3)), 4)  # degree > 3


def test_differentiable_wrt_coeffs_and_means():
    def loss(sh, means):
        return jnp.sum(sh_to_color(sh, means, jnp.zeros(3), 2) ** 2)

    sh = jnp.ones((4, 9, 3)) * 0.3
    means = jnp.array([[0.0, 0.1, 2.0]] * 4)
    g_sh, g_m = jax.grad(loss, argnums=(0, 1))(sh, means)
    assert np.all(np.isfinite(np.asarray(g_sh)))
    assert np.all(np.isfinite(np.asarray(g_m)))
    assert np.abs(np.asarray(g_sh)).max() > 0
    assert np.abs(np.asarray(g_m)).max() > 0


def test_mask_sh_bands_progressive_warmup():
    from mojosplat_jax.ops.sh import mask_sh_bands, num_sh_bases

    feats = jnp.ones((5, 16, 3))
    for deg in range(4):
        m = mask_sh_bands(feats, deg)
        keep = num_sh_bases(deg)
        assert float(jnp.sum(m[:, :keep])) == 5 * keep * 3
        assert float(jnp.sum(m[:, keep:])) == 0.0
    # Gradients to masked bands are zero; to active bands nonzero.
    g = jax.grad(lambda f: jnp.sum(mask_sh_bands(f, 1) ** 2))(feats)
    assert float(jnp.sum(jnp.abs(g[:, 4:]))) == 0.0
    assert float(jnp.sum(jnp.abs(g[:, :4]))) > 0.0
