"""The yardstick's table of peaks and the operations and bytes of the
kernels whose roofline shares the benchmark reports.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its full 700 W
power limit): 3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the
tensor cores. A card set below 700 W runs slower; the run prints the
card's power limit beside its result.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flops": 67e12, "power_w": 700.0},
}
DEFAULT = "NVIDIA H100 80GB HBM3"

# K3 (the bilateral reconstruction, radius 2): per pixel and sweep, 25 taps
# of 25 f32 operations; each sweep's radiance and normals (6 f32 a pixel)
# read once, the launch's (rgb * w, w) delta (4 f32 a pixel) written once
K3_TAPS = 25
K3_OPS_PER_TAP = 25
K3_IN_BYTES_PER_PX_SWEEP = 6 * 4
K3_OUT_BYTES_PER_PX = 4 * 4


def k3_bound_s(pixels: int, sweeps: int, launches: int, kind: str = DEFAULT) -> float:
    """The least time ``launches`` K3 launches over ``sweeps`` sweeps of
    ``pixels`` pixels in all could take: each launch's shapes taken alone
    (its sweeps an equal share), the larger of bytes over the HBM peak
    and operations over the f32 peak, summed."""
    if launches <= 0:
        return 0.0
    pk = PEAKS.get(kind, PEAKS[DEFAULT])
    per = sweeps / launches
    ops = pixels * per * K3_TAPS * K3_OPS_PER_TAP
    nbytes = pixels * (per * K3_IN_BYTES_PER_PX_SWEEP + K3_OUT_BYTES_PER_PX)
    return launches * max(ops / pk["f32_flops"], nbytes / pk["hbm_bytes_per_s"])
