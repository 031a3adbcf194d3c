"""compact: stable multi-class compaction (port of mhm2_proxy_tpu/ops/pallas_compact.py).

Rows are (N,) int32 lanes with an int32 class flag in [0, n_classes). For
each emitted class, the class's rows move to a dense prefix in their
original order; rows past the class count are unspecified and callers mask
them. The CUDA kernel is csrc/compact.cu (per-block counts, an exclusive
cumsum of them in plain torch, then one stable scatter per emitted class);
the plain version gathers the nonzero() positions, which are in order.
An emitted class may write only a subset of the lanes (`emit_lanes`): the
kernel then reads and writes only those.
"""

from __future__ import annotations

import torch

from . import kernels

MAX_CLASSES = 4


def compact_classes(lanes, flags, n_classes: int, emit, emit_lanes=None):
    """Returns [(compacted lanes, count 0-dim int32 tensor)] for each class in
    `emit`, in that order. emit_lanes optionally gives, per emitted class,
    the indices of the lanes it writes (default all; the reference's
    pallas_compact.py:190-193)."""
    lanes = tuple(lanes)
    if not 1 <= n_classes <= MAX_CLASSES:
        raise ValueError(f"compact: n_classes {n_classes} not in [1, {MAX_CLASSES}]")
    if emit_lanes is None:
        emit_lanes = [tuple(range(len(lanes)))] * len(emit)
    if len(emit_lanes) != len(emit):
        raise ValueError("compact: emit_lanes must give one lane selection per emitted class")
    if kernels.use_kernel(flags, *lanes):
        return _compact_cuda(lanes, flags, n_classes, emit, emit_lanes)
    return _compact_plain(lanes, flags, emit, emit_lanes)


def _compact_plain(lanes, flags, emit, emit_lanes):
    N = flags.shape[0]
    out = []
    for c, sel in zip(emit, emit_lanes):
        idx = torch.nonzero(flags == c).squeeze(1)
        n = idx.shape[0]
        comp = tuple(torch.cat([lanes[i][idx], lanes[i].new_zeros(N - n)]) for i in sel)
        out.append((comp, torch.tensor(n, dtype=torch.int32, device=flags.device)))
    return out


def _compact_cuda(lanes, flags, n_classes, emit, emit_lanes):
    kernels.require(flags, torch.int32, "compact flags")
    for i, x in enumerate(lanes):
        kernels.require(x, torch.int32, f"compact lane {i}")
    if len(lanes) > 16:
        raise ValueError(f"compact kernel takes <= 16 lanes, got {len(lanes)}")
    N = flags.shape[0]
    dev = flags.device
    lib = kernels.lib()
    st = kernels.stream(dev)
    T = -(-N // 1024)
    counts = torch.empty((n_classes, T), dtype=torch.int32, device=dev)
    kernels.check(lib.mhm2_compact_count(flags.data_ptr(), N, n_classes, counts.data_ptr(), st),
                  "compact")
    offsets = torch.cumsum(counts, 1, dtype=torch.int64) - counts
    totals = counts.sum(1, dtype=torch.int64).to(torch.int32)
    out = []
    for c, sel in zip(emit, emit_lanes):
        ins = tuple(lanes[i] for i in sel)
        buf = torch.empty((len(ins), N), dtype=torch.int32, device=dev)
        comp = tuple(buf[i] for i in range(len(ins)))
        rc = lib.mhm2_compact_scatter(
            kernels.ptrs(ins), kernels.ptrs(comp), len(ins), flags.data_ptr(), N, c,
            n_classes, offsets.data_ptr(), st,
        )
        kernels.check(rc, "compact")
        out.append((comp, totals[c]))
    if N:
        kernels.count_launch("compact")
    return out
