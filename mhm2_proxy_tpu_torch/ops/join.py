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
(each query row walks its own run and stores its answer at its index); the
plain version is the reference's doubling loop and one scatter.
"""

from __future__ import annotations

import torch

from . import kernels
from .u32 import narrow, widen

QUERY_BIT = 1 << 25
IDX_MASK = QUERY_BIT - 1
MAX_PAYLOAD_BITS = 6  # (row | query flag | payload) in one u32


def reach(max_dup: int) -> int:
    """Rows the doubling shifts 1, 2, 4, ... < max_dup span on each side."""
    s = 1
    while s < max_dup:
        s *= 2
    return s - 1


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


def _propagate_plain(lanes, n_valid, kw, payload_bits, n_queries, max_dup):
    dev = lanes[0].device
    src = widen(lanes[kw])
    sq = (src & QUERY_BIT) != 0
    ssrc = src & IDX_MASK
    is_t = ~sq & (ssrc < n_valid)
    prop = torch.where(is_t, ((ssrc + 1) << payload_bits) | (src >> 26), 0)
    # spread the table answer across its equal-key run: sortedness makes
    # key equality at distance s imply the run between, so doubling shifts
    # in both directions cover reach(max_dup) rows each way
    s = 1
    while s < max_dup and s < prop.shape[0]:
        same = None
        for x in lanes[:kw]:
            e = x[s:] == x[:-s]
            same = e if same is None else (same & e)
        miss = torch.zeros((s,), dtype=prop.dtype, device=dev)
        down = torch.cat([miss, torch.where(same, prop[:-s], 0)])
        up = torch.cat([torch.where(same, prop[s:], 0), miss])
        prop = torch.maximum(prop, torch.maximum(down, up))
        s *= 2
    ans = torch.zeros((n_queries,), dtype=torch.int64, device=dev)
    ans[ssrc[sq]] = prop[sq]
    return narrow(ans)


def _propagate_cuda(lanes, n_valid, kw, payload_bits, n_queries, max_dup):
    for i, x in enumerate(lanes):
        kernels.require(x, torch.int32, f"join lane {i}")
    if kw > 8:
        raise ValueError(f"join kernel takes <= 8 key lanes, got {kw}")
    M = lanes[0].shape[0]
    dev = lanes[0].device
    nv = torch.as_tensor(n_valid, dtype=torch.int32, device=dev).reshape(1)
    ans = torch.zeros((n_queries,), dtype=torch.int32, device=dev)
    if M == 0:
        return ans
    rc = kernels.lib().mhm2_join(
        kernels.ptrs(lanes[:kw]), kw, lanes[kw].data_ptr(), M, nv.data_ptr(), payload_bits,
        reach(max_dup), ans.data_ptr(), n_queries, kernels.stream(dev),
    )
    kernels.check(rc, "join")
    kernels.count_launch("join")
    return ans
