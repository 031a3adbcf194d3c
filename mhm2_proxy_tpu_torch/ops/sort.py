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

range_cuts cuts R sorted runs into key ranges for a ranged fold, at order
statistics of their word 0 over all runs (csrc/sort.cu's mhm2_range_cuts,
one launch; the plain version bisects the same values with searchsorted).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
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


def range_cuts(w0_lanes, counts, target_rows: int):
    """Key-range cuts of sorted runs for a ranged fold: Q = max(2,
    ceil(N / target_rows)) ranges over the N live rows, and for each run the
    Q + 1 row offsets of the ranges ((Q, cuts), cuts[j] a list of ints). The
    inner cuts sit at the runs' word 0 (lanes as u32, any stride, counts[j]
    live rows, an int or a 0-dim tensor) where the rank
    floor((N - 1) q / Q) falls in their union, at the first row of that key,
    so every key's rows land in one range. At most two host syncs: the
    counts held on the device, and the cuts."""
    lanes = tuple(w0_lanes)
    counts = _host_counts(counts)
    Q = max(2, -(-sum(counts) // target_rows))
    cuts = range_select(lanes, counts, Q)[0].cpu()
    trace.count("d2h_bytes", cuts.numel() * cuts.element_size())
    trace.count("parts", len(lanes))
    trace.count("ranges", Q)
    return Q, cuts.tolist()


def _host_counts(counts):
    """The counts as ints, those held in tensors read in one copy."""
    held = [c for c in counts if isinstance(c, torch.Tensor)]
    read = iter(torch.stack([c.reshape(()).to(torch.int64) for c in held]).tolist()
                if held else ())
    return [next(read) if isinstance(c, torch.Tensor) else int(c) for c in counts]


def range_select(w0_lanes, counts, Q: int):
    """The selection of range_cuts for Q ranges, on the lanes' device:
    ((R, Q + 1) int64 cuts, (Q - 1,) int64 edges: the key each inner cut
    starts at, 0 when no run has a row). counts are host ints."""
    lanes, counts = tuple(w0_lanes), [int(n) for n in counts]
    if not lanes or len(counts) != len(lanes) or Q < 2:
        raise ValueError(f"range cuts: {len(lanes)} lanes, {len(counts)} counts, Q={Q}")
    for i, (x, n) in enumerate(zip(lanes, counts)):
        kernels.require_lane(x, f"range cuts lane {i}")
        if not 0 <= n <= x.shape[0]:
            raise ValueError(f"range cuts: lane {i} has {x.shape[0]} rows, count {n}")
    if kernels.use_kernel(*lanes):
        return _range_select_cuda(lanes, counts, Q)
    return _range_select_plain(lanes, counts, Q)


def _range_select_plain(lanes, counts, Q):
    dev = lanes[0].device
    runs = [widen(x[:n]) for x, n in zip(lanes, counts)]
    N = sum(counts)
    q = torch.arange(1, Q, dtype=torch.int64, device=dev)
    lo = torch.zeros_like(q)
    if N:
        # the smallest v whose rows <= v over every run pass the rank t
        t = (N - 1) * q // Q
        hi = torch.full_like(q, 0xFFFFFFFF)
        for _ in range(32):
            mid = (lo + hi) >> 1
            c = sum(torch.searchsorted(r, mid, right=True) for r in runs if r.numel())
            big = c > t
            hi = torch.where(big, mid, hi)
            lo = torch.where(big, lo, mid + 1)
    cuts = torch.stack([
        torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                   torch.searchsorted(r, lo) if r.numel() else torch.zeros_like(lo),
                   torch.tensor([n], device=dev)])
        for r, n in zip(runs, counts)])
    return cuts, lo


# the runs the range cuts kernel takes (csrc/sort.cu's kRangeMaxParts: they
# travel by value, as kernel parameters)
RANGE_MAX_RUNS = 160


def _range_select_cuda(lanes, counts, Q):
    R = len(lanes)
    if R > RANGE_MAX_RUNS or max(counts) >= 1 << 31:
        raise ValueError(f"range cuts kernel takes <= {RANGE_MAX_RUNS} runs of < 2^31 rows: "
                         f"{R} runs, {max(counts)} rows")
    dev = lanes[0].device
    cuts = torch.empty((R, Q + 1), dtype=torch.int64, device=dev)
    edges = torch.empty((Q - 1,), dtype=torch.int64, device=dev)
    rc = kernels.lib().mhm2_range_cuts(
        kernels.ptrs(lanes), kernels.strides(lanes), (ctypes.c_int64 * R)(*counts), R, Q,
        cuts.data_ptr(), edges.data_ptr(), kernels.stream(dev),
    )
    kernels.check(rc, "range_cuts")
    kernels.count_launch("range_cuts")
    return cuts, edges
