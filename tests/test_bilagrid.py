"""Bilateral-grid appearance correction (mojosplat_jax/bilagrid.py).

The gsplat-ecosystem lib_bilagrid capability, reformulated gather-free
(spatial dims via jax.image.resize, guidance dim via a static hat-weight
loop). No reference analogue (forward-only renderer, no
appearance module)."""

import numpy as np
import jax
import jax.numpy as jnp
import optax

from mojosplat_jax import (
    apply_bilateral_grid,
    bilateral_grid_tv,
    identity_bilateral_grid,
)

H, W = 48, 64


def make_image(seed=0):
    rng = np.random.default_rng(seed)
    return jnp.array(rng.uniform(0.05, 0.95, (H, W, 3)).astype(np.float32))


class TestBilateralGrid:
    def test_identity_grid_is_noop(self):
        img = make_image()
        grid = identity_bilateral_grid(1)[0]
        out = jax.jit(apply_bilateral_grid)(img, grid)
        np.testing.assert_allclose(out, img, atol=1e-5)

    def test_uniform_gain(self):
        img = make_image()
        grid = identity_bilateral_grid(1)[0] * 2.0  # A = 2I, b = 0
        out = jax.jit(apply_bilateral_grid)(img, grid)
        np.testing.assert_allclose(out, 2.0 * img, atol=1e-5)

    def test_guidance_selectivity(self):
        # Grid varies only along the guidance dim: dark pixels keep
        # identity, bright pixels gain a constant red bias.
        gh, gw, gd = 16, 16, 8
        grid = np.asarray(identity_bilateral_grid(1, (gh, gw, gd))[0]).copy()
        grid[:, :, gd // 2 :, 9] += 0.25  # red bias for luma >= ~0.5
        dark = jnp.full((H, W, 3), 0.1)
        bright = jnp.full((H, W, 3), 0.9)
        out_d = apply_bilateral_grid(dark, jnp.array(grid))
        out_b = apply_bilateral_grid(bright, jnp.array(grid))
        np.testing.assert_allclose(out_d, dark, atol=1e-5)
        np.testing.assert_allclose(
            out_b[..., 0], bright[..., 0] + 0.25, atol=1e-5
        )
        np.testing.assert_allclose(out_b[..., 1:], bright[..., 1:], atol=1e-5)

    def test_spatial_selectivity(self):
        # Left half identity, right half green bias; mid-gray image so the
        # guidance dim is constant. Compare far-left vs far-right columns
        # (the bilinear ramp blends the middle).
        gh, gw, gd = 16, 16, 8
        grid = np.asarray(identity_bilateral_grid(1, (gh, gw, gd))[0]).copy()
        grid[:, gw // 2 :, :, 10] += 0.5
        img = jnp.full((H, W, 3), 0.5)
        out = np.asarray(apply_bilateral_grid(img, jnp.array(grid)))
        np.testing.assert_allclose(out[:, :2, 1], 0.5, atol=1e-4)
        np.testing.assert_allclose(out[:, -2:, 1], 1.0, atol=1e-4)

    def test_tv_regularizer(self):
        grids = identity_bilateral_grid(3)
        assert float(bilateral_grid_tv(grids)) == 0.0
        bumped = grids.at[0, 2, 3, 4, 0].add(1.0)
        assert float(bilateral_grid_tv(bumped)) > 0.0
        g = jax.grad(lambda x: bilateral_grid_tv(x))(bumped)
        assert bool(jnp.all(jnp.isfinite(g)))

    def test_optimizes_to_absorb_vignetting(self):
        # A radial gain (vignette) corrupts the target; a learned grid must
        # absorb it: loss after optimization << loss with identity grid.
        img = make_image(1)
        yy, xx = jnp.meshgrid(
            jnp.linspace(-1, 1, H), jnp.linspace(-1, 1, W), indexing="ij"
        )
        vignette = 1.0 - 0.4 * (xx**2 + yy**2)
        target = img * vignette[..., None]

        grid = identity_bilateral_grid(1)[0]
        opt = optax.adam(3e-3)
        state = opt.init(grid)

        @jax.jit
        def step(grid, state):
            def loss_fn(g):
                out = apply_bilateral_grid(img, g)
                return jnp.mean((out - target) ** 2) + 1e-4 * (
                    bilateral_grid_tv(g)
                )

            loss, grads = jax.value_and_grad(loss_fn)(grid)
            upd, state = opt.update(grads, state)
            return optax.apply_updates(grid, upd), state, loss

        loss0 = float(jnp.mean((img - target) ** 2))
        for _ in range(200):
            grid, state, loss = step(grid, state)
        assert float(loss) < 0.05 * loss0
