"""Tests for utils/profiling.py (tracing + roofline accounting)."""

import os

import jax
import jax.numpy as jnp

import pytest

from mojosplat_jax.utils.profiling import (
    CHIP_PEAKS,
    annotate,
    chip_peaks,
    roofline_report,
    trace,
)

H100 = "NVIDIA H100 80GB HBM3"


def test_roofline_headline_shape():
    # Headline workload: 1M gaussians, 1080p, ~4M intersections, fwd+bwd.
    r = roofline_report(
        step_ms=182.0,
        n_pixels=1920 * 1080,
        n_isects=4_000_000,
        n_gaussians=1_000_000,
        sh_bases=16,
        backward=True,
        device_kind=H100,
    )
    assert r.pixels_per_s > 10e6
    assert 0.0 < r.fraction_of_light <= 1.0
    assert r.light_speed_ms == max(r.hbm_bound_ms, r.flop_bound_ms)
    # The blend is compute-bound at this shape, not HBM-bound.
    assert r.flop_bound_ms > r.hbm_bound_ms
    d = r.as_dict()
    assert set(d) >= {"pixels_per_s", "step_ms", "fraction_of_light"}


def test_roofline_forward_cheaper_than_backward():
    kw = dict(
        n_pixels=800 * 600,
        n_isects=500_000,
        n_gaussians=100_000,
        device_kind=H100,
    )
    fwd = roofline_report(step_ms=10.0, backward=False, **kw)
    bwd = roofline_report(step_ms=10.0, backward=True, **kw)
    assert bwd.flops_demand > fwd.flops_demand
    assert bwd.hbm_bytes_demand > fwd.hbm_bytes_demand


def test_roofline_all_chips_defined():
    for kind, peaks in CHIP_PEAKS.items():
        assert {"bf16_tflops", "fp32_tflops", "hbm_gbps"} <= set(peaks)
        r = roofline_report(
            step_ms=100.0, n_pixels=1000, n_isects=1000,
            n_gaussians=1000, device_kind=kind,
        )
        assert r.light_speed_ms > 0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H200"])
def test_unknown_device_has_no_peaks(kind):
    with pytest.raises(ValueError, match="no published peaks"):
        chip_peaks(kind)
    with pytest.raises(ValueError, match="no published peaks"):
        roofline_report(step_ms=1.0, n_pixels=1, n_isects=1, n_gaussians=1,
                        device_kind=kind)


def test_trace_capture_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with annotate("tiny-step"):
            x = jax.jit(lambda a: a * 2 + 1)(jnp.ones((64, 64)))
            jax.block_until_ready(x)
    found = []
    for root, _dirs, files in os.walk(logdir):
        found += [f for f in files if f.endswith((".pb", ".trace.json.gz",
                                                  ".xplane.pb"))]
    assert found, f"no profile artifacts written under {logdir}"
