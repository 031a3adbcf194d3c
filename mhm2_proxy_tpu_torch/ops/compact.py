"""compact: stable multi-class compaction (port of mhm2_proxy_tpu/ops/pallas_compact.py).

Rows carry a class: an (N,) int32 flag in [0, n_classes), or a bool / uint8
keep mask (two classes: nonzero rows are class 0, the rest class 1). For
each emitted class, the class's rows move to a dense prefix in their
original order. compact_lanes is the general form: input lanes are (N,)
int32 views of any element stride (the columns of a row-major (N, W)
words tensor are read in place), each emitted class writes a layout of
output groups (one lane an (N,) tensor; 2 to 16 lanes one row-major
(N, g) tensor; a None source writes 0), and with `fills` the rows past the
class count hold a fill value per group. compact_classes keeps the
reference's signature (rows past the count unspecified; zeros in the plain
version). The CUDA kernel is csrc/compact.cu: one launch a call, a
decoupled look-back over 4096-row tiles; the plain version gathers the
nonzero() positions, which are in order.
"""

from __future__ import annotations

import ctypes

import torch

from . import kernels
from .u32 import ONES, u32

MAX_CLASSES = 4
MAX_EMIT = 4
MAX_OUT = 16  # output lanes of one emitted class
TILE = 4096  # rows of one look-back tile (csrc/compact.cu kTile)


def compact_classes(lanes, flags, n_classes: int, emit, emit_lanes=None):
    """Returns [(compacted lanes, count 0-dim int32 tensor)] for each class in
    `emit`, in that order. emit_lanes optionally gives, per emitted class,
    the indices of the lanes it writes (default all; the reference's
    pallas_compact.py:190-193)."""
    lanes = tuple(lanes)
    if emit_lanes is None:
        emit_lanes = [tuple(range(len(lanes)))] * len(emit)
    if len(emit_lanes) != len(emit):
        raise ValueError("compact: emit_lanes must give one lane selection per emitted class")
    layouts = [tuple((i,) for i in sel) for sel in emit_lanes]
    outs, counts = compact_lanes(lanes, flags, n_classes, emit, layouts)
    return [(out, counts[e]) for e, out in enumerate(outs)]


def compact_lanes(lanes, flags, n_classes: int, emit, layouts, fills=None):
    """Stable compaction of each emitted class into its layout.

    lanes: (N,) int32 views; flags: (N,) int32 classes (other values belong
    to no class) or a bool / uint8 keep mask with n_classes == 2. layouts:
    per emitted class, a tuple of groups, each a tuple of source lane
    indices (None: the constant 0). fills: None (rows past the count
    unspecified) or, per emitted class, one u32 fill value per group.
    Returns (per emitted class a tuple of output tensors, one per group,
    and counts: (len(emit),) int32)."""
    lanes = tuple(lanes)
    emit = tuple(emit)
    layouts = [tuple(tuple(g) for g in lay) for lay in layouts]
    if not 1 <= n_classes <= MAX_CLASSES:
        raise ValueError(f"compact: n_classes {n_classes} not in [1, {MAX_CLASSES}]")
    if not 1 <= len(emit) <= MAX_EMIT or len(layouts) != len(emit):
        raise ValueError(f"compact: {len(emit)} emitted classes, {len(layouts)} layouts")
    if any(not 0 <= c < n_classes for c in emit):
        raise ValueError(f"compact: emitted classes {emit} not in [0, {n_classes})")
    if flags.dtype != torch.int32 and n_classes != 2:
        raise ValueError("compact: a keep mask gives two classes")
    for lay in layouts:
        if sum(len(g) for g in lay) > MAX_OUT:
            raise ValueError(f"compact: an emitted class writes <= {MAX_OUT} lanes")
        for g in lay:
            if not g or any(s is not None and not 0 <= s < len(lanes) for s in g):
                raise ValueError(f"compact: output group {g} (sources < {len(lanes)} or None)")
    if fills is not None and [len(f) for f in fills] != [len(lay) for lay in layouts]:
        raise ValueError("compact: fills must give one value per output group")
    if kernels.use_kernel(flags, *lanes):
        return _compact_cuda(lanes, flags, n_classes, emit, layouts, fills)
    return _compact_plain(lanes, flags, emit, layouts, fills)


def words_layout(W: int, n_pay: int, n_key: int | None = None):
    """compact_lanes layout and fills of a table: (N, W) words (all-ones
    tail) from the first n_key lanes (default W; the columns past them 0),
    then n_pay payload lanes (zero tails) from the lanes after those."""
    n_key = W if n_key is None else n_key
    words = tuple(range(n_key)) + (None,) * (W - n_key)
    return (words,) + tuple((n_key + i,) for i in range(n_pay)), (ONES,) + (0,) * n_pay


def _classes(flags):
    return flags if flags.dtype == torch.int32 else torch.where(flags != 0, 0, 1)


def _empty_group(N, width, dev):
    shape = (N,) if width == 1 else (N, width)
    return torch.empty(shape, dtype=torch.int32, device=dev)


def _compact_plain(lanes, flags, emit, layouts, fills):
    N = flags.shape[0]
    dev = flags.device
    cls = _classes(flags)
    outs, counts = [], []
    for e, (c, lay) in enumerate(zip(emit, layouts)):
        idx = torch.nonzero(cls == c).squeeze(1)
        n = idx.shape[0]
        groups = []
        for gi, g in enumerate(lay):
            cols = [lanes[s][idx] if s is not None else torch.zeros(n, dtype=torch.int32, device=dev)
                    for s in g]
            out = _empty_group(N, len(g), dev)
            out[:n] = torch.stack(cols, 1) if len(g) > 1 else cols[0]
            out[n:] = 0 if fills is None else u32(fills[e][gi])
            groups.append(out)
        outs.append(tuple(groups))
        counts.append(n)
    return outs, torch.tensor(counts, dtype=torch.int32, device=dev)


def _compact_cuda(lanes, flags, n_classes, emit, layouts, fills):
    for i, x in enumerate(lanes):
        kernels.require_lane(x, f"compact lane {i}")
    if len(lanes) > 16:
        raise ValueError(f"compact kernel takes <= 16 lanes, got {len(lanes)}")
    if flags.dtype == torch.bool:
        flags = flags.view(torch.uint8)
    if flags.dtype not in (torch.int32, torch.uint8):
        raise TypeError(f"compact flags: expected int32 classes or a bool / uint8 mask, "
                        f"got {flags.dtype}")
    if not flags.is_contiguous() or flags.data_ptr() % 16:
        flags = flags.clone()  # the kernel reads the flags with 16-byte loads
    N = flags.shape[0]
    dev = flags.device
    outs = [tuple(_empty_group(N, len(g), dev) for g in lay) for lay in layouts]
    if N == 0:
        return outs, torch.zeros((len(emit),), dtype=torch.int32, device=dev)
    n_emit = len(emit)
    cells = n_emit * MAX_OUT
    out_p = (ctypes.c_void_p * cells)()
    out_s = (ctypes.c_int64 * cells)()
    src = (ctypes.c_int * cells)()
    fill = (ctypes.c_uint32 * cells)()
    gw = (ctypes.c_int * cells)()
    n_out = (ctypes.c_int * n_emit)()
    for e, lay in enumerate(layouts):
        lane = 0
        for gi, (g, t) in enumerate(zip(lay, outs[e])):
            for j, s in enumerate(g):
                col = t if t.dim() == 1 else t[:, j]
                k = e * MAX_OUT + lane
                out_p[k] = col.data_ptr()
                out_s[k] = col.stride(0)
                src[k] = -1 if s is None else s
                fill[k] = 0 if fills is None else fills[e][gi] & 0xFFFFFFFF
                gw[k] = len(g) if j == 0 else 0
                lane += 1
        n_out[e] = lane
    T = -(-N // TILE)
    status, ticket, gen = kernels.look_back_scratch("compact", dev, T * n_classes)
    counts = torch.empty((n_emit,), dtype=torch.int32, device=dev)
    rc = kernels.lib().mhm2_compact(
        kernels.ptrs(lanes), kernels.strides(lanes), len(lanes), flags.data_ptr(),
        flags.element_size(), N, n_classes, n_emit, (ctypes.c_int * n_emit)(*emit), n_out,
        out_p, out_s, src, fill, gw, int(fills is not None), counts.data_ptr(),
        status.data_ptr(), status.numel(), ticket.data_ptr(), gen, kernels.stream(dev),
    )
    kernels.check(rc, "compact")
    kernels.count_launch("compact")
    return outs, counts
