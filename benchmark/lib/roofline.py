"""Peaks of an H100 and the bytes and operations of the hand kernels' calls.

The peaks are the data sheet's (NVIDIA H100 SXM5, at its 700 W limit): HBM3
at 3.35 TB/s, and for integer work 64 int32 lanes an SM at the SM clock that
nvidia-smi reports as its maximum, over the SMs the card reports. The counts
are the least work a call's arguments need: each input row read once and
each output row written once, whatever a kernel reads again; for ssw, the
DP cells of its padded problem.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# the least integer operations of one ssw DP cell (chip_smoke.py's count:
# substitution 1, E 2, H 1, F 1, the zero floor 1, the best 1.5)
SSW_OPS_PER_CELL = 7.5


def merge_bytes(args) -> int:
    """mhm2_merge(a, a_stride, na, b, b_stride, nb, out, out_stride,
    n_lanes, kw, splits, n_splits, stream): both runs' rows read and the
    merged rows written, n_lanes int32 lanes each."""
    na, nb, n_lanes = int(args[2]), int(args[5]), int(args[8])
    return 2 * (na + nb) * n_lanes * 4


def int32_ops_per_s(device_index: int = 0) -> float:
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=20).stdout.split()[0])
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def bytes_roofline_pct(total_bytes: int, seconds: float) -> float | None:
    """The least time (bytes over the HBM rate) over the measured time, in %."""
    if seconds <= 0 or total_bytes <= 0:
        return None
    return 100.0 * (total_bytes / HBM_BYTES_PER_S) / seconds
