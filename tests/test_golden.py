"""Golden regression tests: the XLA oracle vs committed reference vectors.

Every other parity test in this suite is *pairwise between live
implementations* (XLA <-> Pallas kernels <-> independent oracles), so a
numerics regression that moves all implementations together — e.g. an
accidental RenderConfig default change, or a formula edit applied to both
paths — passes the whole suite. These tests anchor the forward image,
auxiliary outputs, and per-parameter gradients of both primitive families
to vectors committed in tests/golden/ (SURVEY.md section 4's golden-image
plan; the reference has no equivalent — its only oracle is the live
gsplat fork, tests/test_rasterization.py:39-47 there).

Regenerating the vectors is a DELIBERATE act: scripts/regen_golden.py
refuses to overwrite without --force. Inputs are stored inside the npz,
so the comparison does not depend on RNG stream stability.

Tolerances: goldens were generated on this suite's own CPU backend, so
differences can only come from XLA compiler version changes
(reassociation) — a small rtol absorbs that while still catching any
real numerics change (config defaults move results by >1e-3).

``test_golden_on_gpu`` (marked ``chip``) holds the card to the same vectors,
on both raster routes, with the looser tolerances stated there.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from mojosplat_jax import Camera, RenderConfig, render_gaussians
from mojosplat_jax.surfel import render_surfels

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

RTOL = 5e-5
ATOL = 5e-6


def load_golden(family):
    path = os.path.join(GOLDEN_DIR, f"render_{family}.npz")
    assert os.path.exists(path), (
        f"missing golden vector {path} — generate with "
        "scripts/regen_golden.py"
    )
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def make_camera():
    return Camera.create(
        R=np.eye(3, dtype=np.float32), T=np.zeros(3, np.float32),
        H=64, W=64, fx=70.0, fy=70.0, cx=32.0, cy=32.0,
    )


CFG = RenderConfig(tile_capacity=128, chunk_size=32, raster_impl="xla")
BG = (0.15, 0.05, 0.25)


def run_family(family, params, config=CFG):
    import jax

    cam = make_camera()
    bg = jnp.array(BG)
    if family == "3dgs":
        def forward(p):
            img, depth = render_gaussians(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, sh_degree=2, background_color=bg,
                config=config, return_depth=True,
            )
            return img, {"depth": depth}
    else:
        def forward(p):
            img, depth, normal, dist = render_surfels(
                p["means3d"], p["scales"], p["quats"], p["opacities"],
                p["features"], cam, sh_degree=2, background_color=bg,
                config=config, return_depth=True, return_normals=True,
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
    return img, aux, grads


@pytest.mark.parametrize("family", ["3dgs", "2dgs"])
def test_golden_forward_and_grads(family):
    golden = load_golden(family)
    params = {
        k[len("in_"):]: jnp.asarray(v)
        for k, v in golden.items() if k.startswith("in_")
    }
    img, aux, grads = run_family(family, params)

    np.testing.assert_allclose(
        np.asarray(img), golden["image"], rtol=RTOL, atol=ATOL,
        err_msg=f"{family}: forward image drifted from the golden vector",
    )
    for k, v in aux.items():
        np.testing.assert_allclose(
            np.asarray(v), golden[f"aux_{k}"], rtol=RTOL,
            atol=ATOL * float(np.abs(golden[f"aux_{k}"]).max() + 1.0),
            err_msg=f"{family}: aux output {k} drifted",
        )
    for k, g in grads.items():
        ref = golden[f"grad_{k}"]
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(
            np.asarray(g), ref, rtol=RTOL, atol=ATOL * (scale + 1e-12),
            err_msg=f"{family}: gradient for {k} drifted",
        )


@pytest.mark.parametrize("family", ["3dgs", "2dgs"])
def test_golden_vectors_complete(family):
    """Every expected key is present (a truncated regen would silently
    weaken the anchor)."""
    golden = load_golden(family)
    expected_grads = {"means3d", "scales", "quats", "opacities", "features"}
    have_grads = {k[len("grad_"):] for k in golden if k.startswith("grad_")}
    assert have_grads == expected_grads
    assert "image" in golden and golden["image"].shape == (64, 64, 3)
    aux = {k for k in golden if k.startswith("aux_")}
    assert aux == ({"aux_depth"} if family == "3dgs"
                   else {"aux_depth", "aux_normal", "aux_distortion"})


# On the card: float32 exp and sums differ from the CPU's in the last ulps,
# and a pixel whose transmittance sits at the 1e-4 early-termination bound
# may blend one gaussian more or less (weight < 1e-4). Images and aux maps
# are therefore held to 2e-4 absolute (scaled by the map's range), and
# gradients to 2e-3 of each parameter's largest gradient.
CHIP_ATOL = 2e-4
CHIP_GRAD_TOL = 2e-3


@pytest.mark.chip
@pytest.mark.parametrize(
    "family, impl", [("3dgs", "xla"), ("3dgs", "pallas"), ("2dgs", "xla")]
)
def test_golden_on_gpu(gpu, family, impl):
    golden = load_golden(family)
    params = {
        k[len("in_"):]: jnp.asarray(v)
        for k, v in golden.items() if k.startswith("in_")
    }
    config = RenderConfig(tile_capacity=128, chunk_size=32, raster_impl=impl)
    img, aux, grads = run_family(family, params, config)
    np.testing.assert_allclose(
        np.asarray(img), golden["image"], rtol=0, atol=CHIP_ATOL,
        err_msg=f"{family}/{impl} on {gpu.device_kind}: image",
    )
    for k, v in aux.items():
        ref = golden[f"aux_{k}"]
        np.testing.assert_allclose(
            np.asarray(v), ref, rtol=0,
            atol=CHIP_ATOL * float(np.abs(ref).max() + 1.0),
            err_msg=f"{family}/{impl}: aux {k}",
        )
    for k, g in grads.items():
        ref = golden[f"grad_{k}"]
        np.testing.assert_allclose(
            np.asarray(g), ref, rtol=0,
            atol=CHIP_GRAD_TOL * float(np.abs(ref).max() + 1e-12),
            err_msg=f"{family}/{impl}: gradient {k}",
        )
