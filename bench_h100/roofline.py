"""Roofline arithmetic from frozen work counts and published peaks.

A cell's workload file holds, for each kernel group, the work one grid
point needs: bytes (each input read once, each output written once),
float32 operations and special-function (MUFU) operations, counted once on
a stated build and never again. The least time the card could take for a
step is the largest of each count over its peak rate; a kernel's share of
its roofline is that time over the kernel's measured time.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 (80GB HBM3) at its 700 W limit: the data sheet's
# float32 rate outside the tensor cores (132 SMs x 128 FMA lanes x 2 x
# 1.98 GHz), the special-function units' rate (132 SMs x 16 x 1.98 GHz)
# and the HBM3 rate.
PEAKS = {
    "flops_per_s": 6.69e13,
    "mufu_per_s": 4.18e12,
    "bytes_per_s": 3.35e12,
}


def bound_seconds(work: dict, points: int, peaks: dict = PEAKS) -> float:
    """Least seconds one step of ``points`` grid points can take: the
    largest of its float32 operations, MUFU operations and bytes, each at
    its peak rate. ``work`` gives each per point."""
    return points * max(work["flops_per_point"] / peaks["flops_per_s"],
                        work["mufu_per_point"] / peaks["mufu_per_s"],
                        work["bytes_per_point"] / peaks["bytes_per_s"])

