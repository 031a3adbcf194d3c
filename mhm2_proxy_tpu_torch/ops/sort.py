"""sort: merge of two sorted multi-lane runs (port of mhm2_proxy_tpu/ops/pallas_sort.py).

Runs are tuples of (N,) int32 lanes holding u32 values, lexsorted on their
first kw lanes (lane 0 most significant, unsigned: the all-ones sentinel
sorts last). The merge is stable (rows of `a` before rows of `b` on equal
keys), so it equals a stable lexsort of the concatenation; the reference's
bitonic network is not stable, which its consumers never observe (packed
rows are all key, and the join and ctg rules are order-free within a key).
The CUDA kernel is csrc/sort.cu; the plain version is concat + lexsort.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .u32 import ONES, lexsort_lanes, u32

# merge_sorted_lanes_tiled pads its output to a multiple of this many rows
TILE = 1024


def merge_sorted_lanes(a_lanes, b_lanes, kw: int, n_out: int | None = None,
                       pad_fill=None):
    """Merge two sorted runs into n_out >= len(a) + len(b) rows (default
    exactly that). Rows past len(a) + len(b) are pad rows: all-ones keys
    and pad_fill[i] (default 0) in the i-th non-key lane."""
    a_lanes, b_lanes = tuple(a_lanes), tuple(b_lanes)
    if len(a_lanes) != len(b_lanes) or not 1 <= kw <= len(a_lanes):
        raise ValueError(f"merge: {len(a_lanes)} vs {len(b_lanes)} lanes, kw={kw}")
    total = a_lanes[0].shape[0] + b_lanes[0].shape[0]
    n_out = total if n_out is None else n_out
    if n_out < total:
        raise ValueError(f"merge: n_out {n_out} < {total} rows")
    fill = [ONES] * kw + [u32(v) for v in (pad_fill or [0] * (len(a_lanes) - kw))]
    if len(fill) != len(a_lanes):
        raise ValueError("merge: pad_fill must give one value per non-key lane")
    if kernels.use_kernel(*a_lanes, *b_lanes):
        return _merge_cuda(a_lanes, b_lanes, kw, n_out, fill)
    return _merge_plain(a_lanes, b_lanes, kw, n_out, fill)


def merge_sorted_lanes_tiled(a_lanes, b_lanes, kw: int, pad_fill=None):
    """Merge returning a TILE multiple of rows; the pads carry pad_fill so a
    caller can tag them for a downstream compaction."""
    total = a_lanes[0].shape[0] + b_lanes[0].shape[0]
    return merge_sorted_lanes(a_lanes, b_lanes, kw, -(-total // TILE) * TILE, pad_fill)


def _merge_plain(a_lanes, b_lanes, kw, n_out, fill):
    total = a_lanes[0].shape[0] + b_lanes[0].shape[0]
    dev = a_lanes[0].device
    cat = tuple(
        torch.cat([x, y, torch.full((n_out - total,), f, dtype=torch.int32, device=dev)])
        for x, y, f in zip(a_lanes, b_lanes, fill)
    )
    return lexsort_lanes(cat, kw)


def _merge_cuda(a_lanes, b_lanes, kw, n_out, fill):
    n_lanes = len(a_lanes)
    for i, x in enumerate(a_lanes + b_lanes):
        kernels.require(x, torch.int32, f"merge lane {i}")
    if n_lanes > 16 or kw > 8:
        raise ValueError(f"merge kernel takes <= 16 lanes and <= 8 key lanes: {n_lanes}, {kw}")
    dev = a_lanes[0].device
    out = torch.empty((n_lanes, n_out), dtype=torch.int32, device=dev)
    lanes = tuple(out[i] for i in range(n_lanes))
    if n_out == 0:
        return lanes
    fill_arr = (ctypes.c_uint32 * n_lanes)(*[v & 0xFFFFFFFF for v in fill])
    rc = kernels.lib().mhm2_merge(
        kernels.ptrs(a_lanes), a_lanes[0].shape[0], kernels.ptrs(b_lanes), b_lanes[0].shape[0],
        kernels.ptrs(lanes), n_lanes, kw, n_out, ctypes.cast(fill_arr, ctypes.c_void_p),
        kernels.stream(dev),
    )
    kernels.check(rc, "sort")
    kernels.count_launch("sort")
    return lanes
