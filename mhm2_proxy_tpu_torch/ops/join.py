"""join: answer propagation over a merged sort-join run (port of
mhm2_proxy_tpu/ops/pallas_join.py).

ops/lookup.py merges the sorted table rows with the sorted query rows; each
merged row has kw key lanes and one source lane: table idx | payload << 26,
or query idx | QUERY_BIT (pad rows 0x01FFFFFF). A valid table row (idx <
n_valid) answers (idx + 1) << payload_bits | payload. propagate_answers
returns, at each query index, the largest answer in the query's equal-key
run within the span of the reference's doubling shifts (0 if none): the
reference's propagate_compact plus its ragged_append and destination sort
(mhm2_proxy_tpu/ops/lookup.py:117-137). The CUDA kernel is csrc/join.cu
(tiles of merged rows with reach-row halos in shared memory, a van
Herk/Gil-Werman window maximum there; past 4 MB of answers they are staged
by window of query indices and written out in order; reach <= 255, so
max_dup <= 256; query ids distinct, and where repeated ids overflow the
staging the wrapper raises); the plain version is the reference's doubling
loop and one scatter.

propagate_answers_sep is the same over the separate-lane layout that tables
or query sets of 2^25 rows and more need (the reference's XLA branch,
lookup.py:144-247): kw key lanes, a source lane (row idx, bit 31 on query
rows) and a payload lane; a valid table row answers the int64
(idx + 1) << 32 | payload.
"""

from __future__ import annotations

import torch

from . import kernels
from .u32 import narrow, widen

QUERY_BIT = 1 << 25
IDX_MASK = QUERY_BIT - 1
MAX_PAYLOAD_BITS = 6  # (row | query flag | payload) in one u32
SEP_QUERY_BIT = 1 << 31  # the separate-lane layout's query flag


def reach(max_dup: int) -> int:
    """Rows the doubling shifts 1, 2, 4, ... < max_dup span on each side."""
    s = 1
    while s < max_dup:
        s *= 2
    return s - 1


MAX_KERNEL_REACH = 255  # csrc/join.cu's halo


def _kernel_reach(max_dup: int) -> int:
    r = reach(max_dup)
    if r > MAX_KERNEL_REACH:
        raise ValueError(f"join kernel: max_dup {max_dup} spans {r} rows, past its "
                         f"{MAX_KERNEL_REACH}-row halo")
    return r


def propagate_answers(merged_lanes, n_valid, kw: int, payload_bits: int, n_queries: int,
                      max_dup: int = 32):
    """(n_queries,) int32 answers (u32 bits) in query order. n_valid: int or
    0-dim int32 tensor, the table's valid row count."""
    lanes = tuple(merged_lanes)
    if len(lanes) != kw + 1 or not 0 <= payload_bits <= MAX_PAYLOAD_BITS:
        raise ValueError(f"join: {len(lanes)} lanes for kw={kw}, payload_bits={payload_bits}")
    if n_queries > QUERY_BIT:
        raise ValueError(f"join: {n_queries} queries exceed the {QUERY_BIT}-row id field")
    if kernels.use_kernel(*lanes):
        return _propagate_cuda(lanes, n_valid, kw, payload_bits, n_queries, max_dup)
    return _propagate_plain(lanes, n_valid, kw, payload_bits, n_queries, max_dup)


def _spread(prop, key_lanes, max_dup: int):
    """The reference's doubling shifts: each row takes the largest answer
    within reach(max_dup) rows each way in its equal-key run (sortedness
    makes key equality at distance s imply the run between)."""
    s = 1
    while s < max_dup and s < prop.shape[0]:
        same = None
        for x in key_lanes:
            e = x[s:] == x[:-s]
            same = e if same is None else (same & e)
        miss = torch.zeros((s,), dtype=prop.dtype, device=prop.device)
        down = torch.cat([miss, torch.where(same, prop[:-s], 0)])
        up = torch.cat([torch.where(same, prop[s:], 0), miss])
        prop = torch.maximum(prop, torch.maximum(down, up))
        s *= 2
    return prop


def _propagate_plain(lanes, n_valid, kw, payload_bits, n_queries, max_dup):
    src = widen(lanes[kw])
    sq = (src & QUERY_BIT) != 0
    ssrc = src & IDX_MASK
    is_t = ~sq & (ssrc < n_valid)
    prop = _spread(torch.where(is_t, ((ssrc + 1) << payload_bits) | (src >> 26), 0),
                   lanes[:kw], max_dup)
    ans = torch.zeros((n_queries,), dtype=torch.int64, device=src.device)
    ans[ssrc[sq]] = prop[sq]
    return narrow(ans)


def propagate_answers_sep(merged_lanes, n_valid, kw: int, n_queries: int, max_dup: int = 32):
    """(n_queries,) int64 answers (idx + 1) << 32 | payload in query order
    (0: no valid table row with the query's key within reach)."""
    lanes = tuple(merged_lanes)
    if len(lanes) != kw + 2:
        raise ValueError(f"join: {len(lanes)} lanes for kw={kw} + source + payload")
    if kernels.use_kernel(*lanes):
        return _propagate_sep_cuda(lanes, n_valid, kw, n_queries, max_dup)
    return _propagate_sep_plain(lanes, n_valid, kw, n_queries, max_dup)


def _propagate_sep_plain(lanes, n_valid, kw, n_queries, max_dup):
    src = widen(lanes[kw])
    sq = src >= SEP_QUERY_BIT
    ssrc = src & (SEP_QUERY_BIT - 1)
    is_t = ~sq & (ssrc < n_valid)
    prop = _spread(torch.where(is_t, ((ssrc + 1) << 32) | widen(lanes[kw + 1]), 0),
                   lanes[:kw], max_dup)
    ans = torch.zeros((n_queries,), dtype=torch.int64, device=src.device)
    ans[ssrc[sq]] = prop[sq]
    return ans


def _check_staging(scratch) -> None:
    """Raise where the staged answers overflowed: the kernel sets the
    scratch's last int32 when repeated query ids fill a staging bucket or
    image past its ids (answers were dropped)."""
    if scratch.numel() and int(scratch[-4:].view(torch.int32)):
        raise ValueError("join kernel: query ids repeat (a staging bucket overflowed); "
                         "the query ids must be distinct")


def _answers(lib, n_queries: int, dtype, dev):
    """The answers and the kernel's staging buffer. Where the answers fit
    one 4 MB bucket the kernel stores the nonzero ones directly (the rest
    stay zero, so the answers are zero-filled here); past it the kernel
    stages (dest, answer) pairs and writes every answer itself."""
    n = lib.mhm2_join_scratch_bytes(n_queries, torch.empty((), dtype=dtype).element_size())
    if n < 0:
        raise ValueError(f"join kernel: {n_queries} queries; it takes fewer than 2^31")
    ans = (torch.zeros if n == 0 else torch.empty)((n_queries,), dtype=dtype, device=dev)
    return ans, torch.empty((n,), dtype=torch.uint8, device=dev)


def _propagate_cuda(lanes, n_valid, kw, payload_bits, n_queries, max_dup):
    for i, x in enumerate(lanes):
        kernels.require(x, torch.int32, f"join lane {i}")
    if kw > 8:
        raise ValueError(f"join kernel takes <= 8 key lanes, got {kw}")
    M = lanes[0].shape[0]
    dev = lanes[0].device
    nv = torch.as_tensor(n_valid, dtype=torch.int32, device=dev).reshape(1)
    if M == 0:
        return torch.zeros((n_queries,), dtype=torch.int32, device=dev)
    lib = kernels.lib()
    ans, scratch = _answers(lib, n_queries, torch.int32, dev)
    rc = lib.mhm2_join(
        kernels.ptrs(lanes[:kw]), kw, lanes[kw].data_ptr(), M, nv.data_ptr(), payload_bits,
        _kernel_reach(max_dup), ans.data_ptr(), n_queries, scratch.data_ptr(), scratch.numel(),
        kernels.stream(dev),
    )
    kernels.check(rc, "join")
    kernels.count_launch("join")
    _check_staging(scratch)
    return ans


def _propagate_sep_cuda(lanes, n_valid, kw, n_queries, max_dup):
    for i, x in enumerate(lanes):
        kernels.require(x, torch.int32, f"join lane {i}")
    if kw > 8:
        raise ValueError(f"join kernel takes <= 8 key lanes, got {kw}")
    M = lanes[0].shape[0]
    dev = lanes[0].device
    nv = torch.as_tensor(n_valid, dtype=torch.int32, device=dev).reshape(1)
    if M == 0:
        return torch.zeros((n_queries,), dtype=torch.int64, device=dev)
    lib = kernels.lib()
    ans, scratch = _answers(lib, n_queries, torch.int64, dev)
    rc = lib.mhm2_join_sep(
        kernels.ptrs(lanes[:kw]), kw, lanes[kw].data_ptr(), lanes[kw + 1].data_ptr(), M,
        nv.data_ptr(), _kernel_reach(max_dup), ans.data_ptr(), n_queries, scratch.data_ptr(),
        scratch.numel(), kernels.stream(dev),
    )
    kernels.check(rc, "join")
    kernels.count_launch("join")
    _check_staging(scratch)
    return ans
