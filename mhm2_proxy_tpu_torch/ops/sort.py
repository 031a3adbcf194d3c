"""sort: merge of two sorted multi-lane runs (port of mhm2_proxy_tpu/ops/pallas_sort.py).

Runs are tuples of (N,) int32 lanes holding u32 values, lexsorted on their
first kw lanes (lane 0 most significant, unsigned: the all-ones sentinel
sorts last). A lane may be a strided view: the columns of a row-major
(N, W) words tensor merge in place. The merge is stable (rows of `a`
before rows of `b` on equal keys), so it equals a stable lexsort of the
concatenation; the reference's bitonic network is not stable, which its
consumers never observe (packed rows are all key, and the join and ctg
rules are order-free within a key). The output has len(a) + len(b) rows.
The CUDA kernel is csrc/sort.cu (a co-rank partition launch, then a merge
of each tile in shared memory); the plain version is concat + lexsort.
"""

from __future__ import annotations

import torch

from . import kernels
from .u32 import lexsort_lanes, widen


def merge_sorted_lanes(a_lanes, b_lanes, kw: int, as_words: bool = False):
    """Merge two sorted runs into len(a) + len(b) rows: the merged lanes,
    or with as_words (words (N, kw) row-major, *the payload lanes)."""
    a_lanes, b_lanes = tuple(a_lanes), tuple(b_lanes)
    if len(a_lanes) != len(b_lanes) or not 1 <= kw <= len(a_lanes):
        raise ValueError(f"merge: {len(a_lanes)} vs {len(b_lanes)} lanes, kw={kw}")
    if kernels.use_kernel(*a_lanes, *b_lanes):
        return _merge_cuda(a_lanes, b_lanes, kw, as_words)
    return _merge_plain(a_lanes, b_lanes, kw, as_words)


def _merge_plain(a_lanes, b_lanes, kw, as_words):
    out = lexsort_lanes(tuple(torch.cat([x, y]) for x, y in zip(a_lanes, b_lanes)), kw)
    return (torch.stack(out[:kw], dim=-1),) + out[kw:] if as_words else out


def merge_path_splits(a_lanes, b_lanes, kw: int, tile: int):
    """The plain version of the sort kernel's partition launch: for t = 0 ..
    ceil((na + nb) / tile), how many rows of `a` precede output row
    min(t * tile, na + nb) in the stable merge ((T + 1,) int64), by the
    kernel's binary search (the smallest i with b[d - i - 1] < a[i]) run
    for every boundary at once."""
    na, nb = a_lanes[0].shape[0], b_lanes[0].shape[0]
    dev = a_lanes[0].device
    total = na + nb
    diag = torch.clamp(torch.arange(-(-total // tile) + 1, device=dev) * tile, max=total)
    lo = torch.clamp(diag - nb, min=0)
    hi = torch.clamp(diag, max=na)
    a_keys = [widen(x) for x in a_lanes[:kw]]
    b_keys = [widen(x) for x in b_lanes[:kw]]
    while bool((lo < hi).any()):
        mid = (lo + hi) >> 1
        ia = torch.clamp(mid, max=max(na - 1, 0))
        jb = torch.clamp(diag - mid - 1, min=0, max=max(nb - 1, 0))
        b_lt = torch.zeros_like(diag, dtype=torch.bool)
        eq = torch.ones_like(b_lt)
        for x, y in zip(a_keys, b_keys):
            av, bv = x[ia], y[jb]
            b_lt |= eq & (bv < av)
            eq &= bv == av
        active = lo < hi
        hi = torch.where(active & b_lt, mid, hi)
        lo = torch.where(active & ~b_lt, mid + 1, lo)
    return lo


def _merge_cuda(a_lanes, b_lanes, kw, as_words):
    n_lanes = len(a_lanes)
    for i, x in enumerate(a_lanes + b_lanes):
        kernels.require_lane(x, f"merge lane {i}")
    if n_lanes > 16 or kw > 8:
        raise ValueError(f"merge kernel takes <= 16 lanes and <= 8 key lanes: {n_lanes}, {kw}")
    na, nb = a_lanes[0].shape[0], b_lanes[0].shape[0]
    total = na + nb
    dev = a_lanes[0].device
    if as_words:
        words = torch.empty((total, kw), dtype=torch.int32, device=dev)
        pay = torch.empty((n_lanes - kw, total), dtype=torch.int32, device=dev)
        result = (words,) + tuple(pay[i] for i in range(n_lanes - kw))
        lanes = tuple(words[:, i] for i in range(kw)) + result[1:]
    else:
        buf = torch.empty((n_lanes, total), dtype=torch.int32, device=dev)
        result = lanes = tuple(buf[i] for i in range(n_lanes))
    if total == 0:
        return result
    lib = kernels.lib()
    n_splits = -(-total // lib.mhm2_merge_tile_rows(kw)) + 1
    splits = torch.empty((n_splits,), dtype=torch.int64, device=dev)
    rc = lib.mhm2_merge(
        kernels.ptrs(a_lanes), kernels.strides(a_lanes), na, kernels.ptrs(b_lanes),
        kernels.strides(b_lanes), nb, kernels.ptrs(lanes), kernels.strides(lanes), n_lanes, kw,
        splits.data_ptr(), n_splits, kernels.stream(dev),
    )
    kernels.check(rc, "sort")
    kernels.count_launch("sort")
    return result
