"""Profiler tracing + roofline accounting (SURVEY.md section 5, tracing row).

The reference's only performance tooling is the external benchmark harness's
``torch.cuda.synchronize()``-fenced wall clock (examples/benchmark_proj.py
:124-145); it has no in-pipeline tracing, no profiler hooks, and no roofline
accounting. This module supplies:

  - ``trace(logdir)``: captures a device profile via ``jax.profiler`` that
    opens in Perfetto / TensorBoard (per-HLO device timelines, kernels).
  - ``annotate(name)``: named trace regions so pipeline stages (projection /
    binning / gather / raster) are attributable inside a capture.
  - ``roofline_report(...)``: achieved pixels/s plus lower-bound bandwidth
    and FLOP demands of the 3DGS workload against the device's peaks.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import jax

# Published peaks per device, keyed by ``jax.Device.device_kind``, used only
# as roofline denominators. Source: NVIDIA's H100 SXM data sheet, dense
# rates without sparsity, at the full 700 W power limit: 989 TFLOP/s bf16,
# 495 TF32, 67 float32 outside the tensor cores, 3.35 TB/s HBM3. A card set
# below 700 W (nvidia-smi power.limit) cannot hold these rates.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "fp32_tflops": 67.0,
        "hbm_gbps": 3350.0,
    },
}


def chip_peaks(device_kind: str) -> dict:
    """Peaks of ``device_kind``; a device missing from the table is an error."""
    try:
        return CHIP_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; add a row to "
            "CHIP_PEAKS with its source"
        ) from None


@contextmanager
def trace(logdir: str):
    """Capture a device trace under ``logdir`` (view in Perfetto/TensorBoard).

    Usage::

        with trace("/tmp/mojosplat-trace"):
            loss = train_step(...)   # must block inside the context
            jax.block_until_ready(loss)
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextmanager
def annotate(name: str):
    """Named region inside a trace capture (shows up on the device timeline)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@dataclass(frozen=True)
class RooflineReport:
    """Achieved throughput vs lower-bound resource demands of one train step.

    All "demand" fields are *lower bounds* computed from workload shape, not
    measured counters: bytes assume each operand is touched once from HBM;
    FLOPs count only the unavoidable per-(pixel, intersection) blending math
    and per-gaussian projection math. Ratios > 1.0 are impossible; a ratio of
    0.5 means the step runs at half the speed light allows for that resource.
    """

    pixels_per_s: float
    step_ms: float
    hbm_bytes_demand: float
    flops_demand: float
    hbm_bound_ms: float  # demand / device HBM peak
    flop_bound_ms: float  # demand / device FLOP peak
    light_speed_ms: float  # max(hbm_bound, flop_bound)
    fraction_of_light: float  # light_speed_ms / step_ms

    def as_dict(self) -> dict:
        return {
            "pixels_per_s": self.pixels_per_s,
            "step_ms": self.step_ms,
            "hbm_bound_ms": self.hbm_bound_ms,
            "flop_bound_ms": self.flop_bound_ms,
            "light_speed_ms": self.light_speed_ms,
            "fraction_of_light": self.fraction_of_light,
        }


def roofline_report(
    step_ms: float,
    n_pixels: int,
    n_isects: int,
    n_gaussians: int,
    sh_bases: int = 16,
    backward: bool = True,
    device_kind: str = "NVIDIA H100 80GB HBM3",
    tile_size: int = 16,
) -> RooflineReport:
    """Roofline accounting for one fwd(+bwd) render step.

    Demand model (lower bounds):
      - HBM: gaussian parameters + SH coefficients read once per pass;
        per-intersection slot records written+read once by binning/gather
        (12 f32 fields: mean, conic, color, opacity, ids, residuals);
        image + grads once.
      - FLOPs: ~24 f32 ops per (pixel, intersection) pair per pass for the
        EWA blend — sigma (5 FMA), exp, alpha/transmittance update,
        3-channel accumulate — counted for every pixel of every kept slot's
        tile, at the float32 rate outside the tensor cores (the blend has no
        matrix product). Early exit skips pairs, so this over-counts the
        work a kernel must do and the share is an upper bound; plus ~300 per
        gaussian for projection and 2*sh_bases*3 for SH, negligible next to
        the blend at headline shapes.
    """
    peaks = chip_peaks(device_kind)
    passes = 2.6 if backward else 1.0  # bwd re-walks tiles + routes grads

    param_bytes = n_gaussians * (11 + 3 * sh_bases) * 4.0
    slot_bytes = n_isects * 12 * 4.0 * (3.0 if backward else 2.0)
    image_bytes = n_pixels * 4 * 4.0 * (2.0 if backward else 1.0)
    hbm = (param_bytes * passes) + slot_bytes + image_bytes

    pixels_per_tile = float(tile_size * tile_size)
    blend_flops = n_isects * pixels_per_tile * 24.0 * passes
    proj_flops = n_gaussians * (300.0 + 2 * sh_bases * 3) * passes
    flops = blend_flops + proj_flops

    hbm_bound_ms = hbm / (peaks["hbm_gbps"] * 1e9) * 1e3
    flop_bound_ms = flops / (peaks["fp32_tflops"] * 1e12) * 1e3
    light = max(hbm_bound_ms, flop_bound_ms)
    return RooflineReport(
        pixels_per_s=n_pixels / (step_ms * 1e-3),
        step_ms=step_ms,
        hbm_bytes_demand=hbm,
        flops_demand=flops,
        hbm_bound_ms=hbm_bound_ms,
        flop_bound_ms=flop_bound_ms,
        light_speed_ms=light,
        fraction_of_light=light / max(step_ms, 1e-9),
    )
