"""finalize: group sums + extension calls + purge over a merged sorted packed
run (port of mhm2_proxy_tpu/ops/pallas_finalize.py).

scan_purge(lanes, k, dmin_thres, purge) -> (data lanes, flags). For every
row it gives the key lanes (payload bits cleared, sentinel rows all-ones)
plus, from the row's inclusive group sums clamped at MAX_KMER_COUNT, either
one packed (count | lcall<<16 | rcall<<24) lane (purge) or the five
ops/count.py::_pack_sums lanes (no purge), and a class flag (0 = keep the
row, 1 = drop). The compact kernel then gathers the kept rows. The CUDA
kernel is csrc/finalize.cu; the plain version follows the reference's XLA
branch of final_from_sorted_packed (count.py:1104-1137): one cumsum, minus
its exclusive value at each row's group start, and elementwise calls.
"""

from __future__ import annotations

import torch

from ..constants import EXT_F, EXT_X, MAX_KMER_COUNT
from . import kernels
from .u32 import ONES, narrow, rows_equal_next, widen


def get_ext_calls(c4, count, dmin_thres: int):
    """Extension call per row (reference kcount_cpu.cpp:173-182): c4 (N, 4)
    and count (N,) integer sums already clamped. Ties break toward the
    greater base (T > G > C > A) via key = count*4 + code; dmin_dyn is the
    integer form ceil(count/10)-1 of the reference's double-precision rule
    (see mhm2_proxy_tpu/ops/count.py:458-482). Returns uint8 codes 0-5."""
    c4 = c4.to(torch.int64)
    count = count.to(torch.int64)
    key = c4 * 4 + torch.arange(4, device=c4.device)[None, :]
    top = key.max(dim=-1).values
    top_code = top % 4
    top_cnt = top // 4
    runner = torch.where(key == top[:, None], -1, key).max(dim=-1).values // 4
    dmin_dyn = torch.clamp((count + 9) // 10 - 1, min=dmin_thres)
    call = torch.where(top_cnt < dmin_dyn, EXT_X, torch.where(runner >= dmin_dyn, EXT_F, top_code))
    return call.to(torch.uint8)


def _keymask(k: int, weff: int) -> int:
    free = 32 * weff - 2 * k
    if weff != -(-2 * k // 32) or free < 7:
        raise ValueError(f"finalize: k={k} does not carry its payload in {weff} packed lanes")
    return 0xFFFFFFFF ^ ((1 << free) - 1)


def scan_purge(sorted_lanes, k: int, dmin_thres: int = 2, purge: bool = True):
    sorted_lanes = tuple(sorted_lanes)
    keymask = _keymask(k, len(sorted_lanes))
    if kernels.use_kernel(*sorted_lanes):
        return _scan_purge_cuda(sorted_lanes, keymask, dmin_thres, purge)
    return _scan_purge_plain(sorted_lanes, keymask, dmin_thres, purge)


def _scan_purge_plain(lanes, keymask: int, dmin_thres: int, purge: bool):
    N = lanes[0].shape[0]
    dev = lanes[0].device
    if N == 0:
        empty = torch.empty((0,), dtype=torch.int32, device=dev)
        return (empty,) * (len(lanes) + (1 if purge else 5)), empty
    slast = widen(lanes[-1])
    skey = slast & keymask
    sent = skey == keymask
    for x in lanes[:-1]:
        sent = sent & (x == ONES)
    clean_last = torch.where(sent, 0xFFFFFFFF, skey)
    neq = ~rows_equal_next(tuple(lanes[:-1]) + (skey,))
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    is_start = torch.cat([one, neq])
    is_last = torch.cat([neq, one])
    cin = (~sent).to(torch.int64)
    left = (slast >> 1) & 7
    right = (slast >> 4) & 7
    # (9, N): scans run along the innermost dimension (a CUDA cumsum over
    # dim 0 of an (N, 9) tensor has 9-way parallelism)
    pay = torch.stack(
        [cin] + [(left == j) * cin for j in range(4)] + [(right == j) * cin for j in range(4)]
    )
    # inclusive group sums: the running sum minus its value before the
    # row's group start (exact in int64, clamped afterwards)
    cs = torch.cumsum(pay, 1)
    gid = torch.cumsum(is_start.to(torch.int64), 0) - 1
    start_excl = (cs - pay)[:, torch.nonzero(is_start).squeeze(1)][:, gid]
    sums = torch.clamp(cs - start_excl, max=MAX_KMER_COUNT).T
    count = sums[:, 0]
    keys = tuple(lanes[:-1]) + (narrow(clean_last),)
    if purge:
        lcall = get_ext_calls(sums[:, 1:5], count, dmin_thres).to(torch.int64)
        rcall = get_ext_calls(sums[:, 5:9], count, dmin_thres).to(torch.int64)
        keep = is_last & ~sent & (count >= 2) & ~((lcall == EXT_X) & (rcall == EXT_X))
        data = keys + (narrow(count | (lcall << 16) | (rcall << 24)),)
    else:
        keep = is_last & ~sent
        data = keys + (
            narrow(count),
            narrow(sums[:, 1] | (sums[:, 2] << 16)),
            narrow(sums[:, 3] | (sums[:, 4] << 16)),
            narrow(sums[:, 5] | (sums[:, 6] << 16)),
            narrow(sums[:, 7] | (sums[:, 8] << 16)),
        )
    flags = torch.where(keep, 0, 1).to(torch.int32)
    return data, flags


def _scan_purge_cuda(lanes, keymask: int, dmin_thres: int, purge: bool):
    for i, x in enumerate(lanes):
        kernels.require(x, torch.int32, f"finalize lane {i}")
    weff = len(lanes)
    n_out = weff + 1 if purge else weff + 5
    N = lanes[0].shape[0]
    dev = lanes[0].device
    T = -(-N // 1024)
    out = torch.empty((n_out, N), dtype=torch.int32, device=dev)
    data = tuple(out[i] for i in range(n_out))
    flags = torch.empty((N,), dtype=torch.int32, device=dev)
    if N == 0:
        return data, flags
    agg_f = torch.empty((T,), dtype=torch.int32, device=dev)
    agg_v = torch.empty((T * 9,), dtype=torch.int32, device=dev)
    carry = torch.empty((T * 9,), dtype=torch.int32, device=dev)
    rc = kernels.lib().mhm2_finalize(
        kernels.ptrs(lanes), weff, N, keymask, dmin_thres, int(purge), kernels.ptrs(data),
        flags.data_ptr(), agg_f.data_ptr(), agg_v.data_ptr(), carry.data_ptr(),
        kernels.stream(dev),
    )
    kernels.check(rc, "finalize")
    kernels.count_launch("finalize")
    return data, flags
