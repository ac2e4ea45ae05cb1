"""Regenerate the committed golden regression vectors (DELIBERATE act).

The golden tests (tests/test_golden.py) pin the XLA-oracle renderer's
forward image and per-parameter gradients for two tiny fixed scenes (one
per primitive family). All other parity tests are *pairwise between live
implementations* (XLA <-> Pallas kernels <-> numpy), so a numerics regression that
moves every implementation together — e.g. an accidental RenderConfig
default change — would pass the whole suite. The committed npz vectors
are the absolute anchor (SURVEY.md section 4: golden-image tests).

Regenerating them REDEFINES the renderer's reference numerics. Only do it
after an intentional, documented numerical-contract change, and say so in
the commit message:

    JAX_PLATFORMS=cpu python -c "import runpy, sys; \
        sys.argv=['x', '--force']; \
        runpy.run_path('scripts/regen_golden.py', run_name='__main__')"

Vectors are generated on the CPU backend (the same backend the test suite
runs on) with inputs STORED in the npz, so the goldens do not depend on
RNG stream stability across numpy versions.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

GOLDEN_DIR = os.path.join("tests", "golden")


def build_inputs():
    """Fixed tiny scenes, one per family. Returns {name: dict of arrays}."""
    rng = np.random.default_rng(20260821)
    n = 96
    base = dict(
        means3d=np.concatenate(
            [rng.normal(0, 0.45, (n, 2)), rng.uniform(1.6, 4.0, (n, 1))],
            axis=1,
        ).astype(np.float32),
        scales=rng.normal(-1.4, 0.25, (n, 3)).astype(np.float32),
        quats=rng.normal(0, 1, (n, 4)).astype(np.float32),
        opacities=rng.uniform(0.3, 0.9, n).astype(np.float32),
        # SH degree 2 features: (n, 9, 3) — covers ops/sh.py in the chain.
        features=rng.normal(0.4, 0.35, (n, 9, 3)).astype(np.float32),
    )
    surfel = dict(base)
    surfel["scales"] = base["scales"][:, :2]  # 2DGS disks
    return {"3dgs": base, "2dgs": surfel}


def render_outputs(inputs, family):
    import jax
    import jax.numpy as jnp

    from mojosplat_jax import Camera, RenderConfig, render_gaussians
    from mojosplat_jax.surfel import render_surfels

    cam = Camera.create(
        R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
        H=64, W=64, fx=70.0, fy=70.0, cx=32.0, cy=32.0,
    )
    cfg = RenderConfig(tile_capacity=128, chunk_size=32, raster_impl="xla")
    bg = jnp.array([0.15, 0.05, 0.25])
    params = {k: jnp.asarray(v) for k, v in inputs.items()}

    if family == "3dgs":
        def forward(p):
            img, depth = render_gaussians(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, sh_degree=2, background_color=bg,
                config=cfg, return_depth=True,
            )
            return img, {"depth": depth}
    else:
        def forward(p):
            img, depth, normal, dist = render_surfels(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, sh_degree=2, background_color=bg,
                config=cfg, return_depth=True, return_normals=True,
                return_distortion=True,
            )
            return img, {"depth": depth, "normal": normal,
                         "distortion": dist}

    def loss(p):
        img, aux = forward(p)
        out = jnp.mean(img ** 2)
        for v in aux.values():
            out = out + 1e-3 * jnp.mean(v ** 2)
        return out

    img, aux = forward(params)
    grads = jax.grad(loss)(params)
    out = {"image": np.asarray(img)}
    for k, v in aux.items():
        out[f"aux_{k}"] = np.asarray(v)
    for k, v in grads.items():
        out[f"grad_{k}"] = np.asarray(v)
    return out


def main():
    import jax

    assert jax.default_backend() == "cpu", (
        "goldens must be generated on the CPU backend (the backend the "
        "test suite runs on); set JAX_PLATFORMS=cpu"
    )
    force = "--force" in sys.argv
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for family, inputs in build_inputs().items():
        path = os.path.join(GOLDEN_DIR, f"render_{family}.npz")
        if os.path.exists(path) and not force:
            raise SystemExit(
                f"{path} exists — regenerating redefines the reference "
                "numerics; re-run with --force if that is intentional "
                "(and document why in the commit message)."
            )
        outputs = render_outputs(inputs, family)
        np.savez_compressed(
            path,
            **{f"in_{k}": v for k, v in inputs.items()},
            **outputs,
        )
        print(f"wrote {path}: "
              + ", ".join(f"{k}{v.shape}" for k, v in outputs.items()),
              flush=True)


if __name__ == "__main__":
    main()
