"""scan: segmented group sums over lexsorted rows (port of
mhm2_proxy_tpu/ops/pallas_scan.py).

group_sums_scan_lanes(pay_lanes, is_start, clamp): for n_pay <= 9 int32
payload lanes (values >= 0) and a group-start flag per row, each lane's
inclusive sum over the row's group up to the row, clamped at `clamp`.

group_sums_scan_packed(sorted_lanes, keymask, clamp): the same over the
count and extension one-hots of a sorted packed record run (the 7-bit read
payload valid | left<<1 | right<<4 in the last lane's bits outside
`keymask`; all-ones key rows are sentinels with count 0, and the first row
starts a group), returned as the five lanes of ops/count.py::_pack_sums.

Both are valid at group-last rows, where callers read them. The CUDA
kernel is csrc/scan.cu: one pass with a decoupled look-back, in 16-bit
saturating sums for a clamp <= 0xFFFF and 32-bit ones above. The plain
versions follow the reference's XLA branch (count.py:239-247): the
inclusive cumsum minus its exclusive value at the group start, then the
clamp, one lane at a time along the innermost dimension (exact in int64).
"""

from __future__ import annotations

import torch

from . import kernels
from .u32 import ONES, narrow, rows_equal_next, widen

MAX_LANES = 9


def group_sums_scan_lanes(pay_lanes, is_start, clamp: int):
    pay_lanes = tuple(pay_lanes)
    if not 1 <= len(pay_lanes) <= MAX_LANES or not 0 <= clamp < (1 << 31):
        raise ValueError(f"scan: {len(pay_lanes)} lanes, clamp {clamp}")
    if kernels.use_kernel(is_start, *pay_lanes):
        return _scan_lanes_cuda(pay_lanes, is_start, clamp)
    return _scan_lanes_plain(pay_lanes, is_start, clamp)


def group_sums_scan_packed(sorted_lanes, keymask: int, clamp: int):
    sorted_lanes = tuple(sorted_lanes)
    if not 1 <= len(sorted_lanes) <= 7 or not 0 <= clamp <= 0xFFFF:
        raise ValueError(f"scan: {len(sorted_lanes)} packed lanes, clamp {clamp}")
    if kernels.use_kernel(*sorted_lanes):
        return _scan_packed_cuda(sorted_lanes, keymask, clamp)
    return _scan_packed_plain(sorted_lanes, keymask, clamp)


def _scan_lanes_plain(pay_lanes, is_start, clamp: int):
    return tuple(x.to(torch.int32) for x in seg_sums_plain(pay_lanes, is_start, clamp))


def _scan_packed_plain(sorted_lanes, keymask: int, clamp: int):
    _keys, _sent, is_start, pay = packed_rows(sorted_lanes, keymask)
    s = seg_sums_plain(pay, is_start, clamp)
    return (narrow(s[0]),) + tuple(narrow(s[i] | (s[i + 1] << 16)) for i in (1, 3, 5, 7))


def seg_sums_plain(pay_lanes, is_start, clamp: int):
    """Inclusive group sums of each (N,) lane, clamped, as int64 lanes. Rows
    before the first start sum from row 0 (a start at row 0 changes nothing:
    its exclusive prefix is 0)."""
    starts = is_start.clone()
    starts[:1] = True
    gid = torch.cumsum(starts.to(torch.int64), 0) - 1
    starts = torch.nonzero(starts).squeeze(1)
    out = []
    for x in pay_lanes:
        x = x.to(torch.int64)
        cs = torch.cumsum(x, 0)
        out.append(torch.clamp(cs - (cs - x)[starts][gid], max=clamp))
    return out


def _starts(key_lanes):
    neq = ~rows_equal_next(key_lanes)
    one = torch.ones((1,), dtype=torch.bool, device=key_lanes[0].device)
    return torch.cat([one, neq])[: key_lanes[0].shape[0]]


def _onehots(cnt, left, right):
    return [cnt] + [(left == j) * cnt for j in range(4)] + [(right == j) * cnt for j in range(4)]


def packed_rows(lanes, keymask: int):
    """Rows of a sorted packed record run: (key lanes with the payload bits
    cleared (int64 last lane), sentinel flags, group starts, the 9 payload
    lanes count, left one-hots, right one-hots as int32)."""
    slast = widen(lanes[-1])
    skey = slast & keymask
    sent = skey == keymask
    for x in lanes[:-1]:
        sent = sent & (x == ONES)
    keys = tuple(lanes[:-1]) + (skey,)
    cnt = (~sent).to(torch.int32)
    return keys, sent, _starts(keys), _onehots(cnt, (slast >> 1) & 7, (slast >> 4) & 7)


def sep_rows(key_lanes, pay):
    """Rows of a key-sorted separate-payload run (weff key lanes + one
    count | left<<16 | right<<24 lane, count 0 on sentinel rows): (sentinel
    flags, group starts, the 9 payload lanes as int32)."""
    p = widen(pay)
    cnt = (p & 0xFFFF).to(torch.int32)
    return cnt == 0, _starts(tuple(key_lanes)), _onehots(cnt, (p >> 16) & 7, (p >> 24) & 7)


TILE_ROWS = 2048  # csrc/scan.cu's kTile: one look-back status word a tile
VALUE_WORDS = 18  # csrc/scan.cu: a tile's aggregate and inclusive prefix, 9 words each


def _launch(entry, lane_args, N, dev):
    """Call a scan C entry with its look-back scratch appended."""
    T = -(-N // TILE_ROWS)
    status, ticket, gen = kernels.look_back_scratch("scan", dev, T)
    vals = torch.empty((T * VALUE_WORDS,), dtype=torch.int32, device=dev)
    rc = entry(*lane_args, status.data_ptr(), status.numel(), vals.data_ptr(), ticket.data_ptr(),
               gen, kernels.stream(dev))
    kernels.check(rc, "scan")
    kernels.count_launch("scan")


def _scan_lanes_cuda(pay_lanes, is_start, clamp):
    for i, x in enumerate(pay_lanes):
        kernels.require(x, torch.int32, f"scan lane {i}")
    kernels.require(is_start, torch.bool, "scan is_start")
    N = is_start.shape[0]
    dev = is_start.device
    if any(x.shape != (N,) for x in pay_lanes):
        raise ValueError("scan: every lane needs the rows of is_start")
    out = torch.empty((len(pay_lanes), N), dtype=torch.int32, device=dev)
    lanes = tuple(out[i] for i in range(len(pay_lanes)))
    if N == 0:
        return lanes
    _launch(kernels.lib().mhm2_scan_lanes,
            (kernels.ptrs(pay_lanes), len(pay_lanes), is_start.data_ptr(), N, clamp,
             kernels.ptrs(lanes)), N, dev)
    return lanes


def _scan_packed_cuda(lanes, keymask, clamp):
    for i, x in enumerate(lanes):
        kernels.require(x, torch.int32, f"scan lane {i}")
    N = lanes[0].shape[0]
    dev = lanes[0].device
    out = torch.empty((5, N), dtype=torch.int32, device=dev)
    sums = tuple(out[i] for i in range(5))
    if N == 0:
        return sums
    _launch(kernels.lib().mhm2_scan_packed,
            (kernels.ptrs(lanes), len(lanes), N, keymask & 0xFFFFFFFF, clamp, kernels.ptrs(sums)),
            N, dev)
    return sums
