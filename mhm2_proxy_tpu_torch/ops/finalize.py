"""finalize: group sums + extension calls + purge over a merged sorted raw
run (port of mhm2_proxy_tpu/ops/pallas_finalize.py).

scan_purge(lanes, k, dmin_thres, purge, pay) -> (data lanes, flags). The
run is packed (payload in the last key lane's free bits) or, with `pay`,
key lanes plus a separate payload lane (k = 63, 77). For every row it gives
the key lanes (payload bits cleared, packed sentinel rows all-ones)
plus, from the row's inclusive group sums clamped at MAX_KMER_COUNT, either
one packed (count | lcall<<16 | rcall<<24) lane (purge) or the five
ops/count.py::_pack_sums lanes (no purge), and a class flag (0 = keep the
row, 1 = drop). The compact kernel then gathers the kept rows. The CUDA
kernel is csrc/finalize.cu; the plain version follows the reference's XLA
branches of final_from_sorted_packed and final_from_sorted_sep
(count.py:1104-1137, 1186-1208): the group sums of ops/scan.py's plain
version, and elementwise calls.
"""

from __future__ import annotations

import torch

from ..constants import EXT_F, EXT_X, MAX_KMER_COUNT
from . import kernels
from .scan import packed_rows, seg_sums_plain, sep_rows
from .u32 import narrow


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


def scan_purge(sorted_lanes, k: int, dmin_thres: int = 2, purge: bool = True, pay=None):
    """pay: None for the packed layout, else the separate payload lane
    (count | left<<16 | right<<24, 0 on sentinel rows) of a key-sorted run
    whose weff lanes are all key (k = 63, 77)."""
    keys = tuple(sorted_lanes)
    if pay is None:
        keymask = _keymask(k, len(keys))
    elif len(keys) != -(-2 * k // 32):
        raise ValueError(f"finalize: k={k} has {-(-2 * k // 32)} key lanes, got {len(keys)}")
    else:
        keymask = 0xFFFFFFFF
    if kernels.use_kernel(*keys, *(() if pay is None else (pay,))):
        return _scan_purge_cuda(keys, pay, keymask, dmin_thres, purge)
    return _scan_purge_plain(keys, pay, keymask, dmin_thres, purge)


def _scan_purge_plain(keys, pay, keymask: int, dmin_thres: int, purge: bool):
    N = keys[0].shape[0]
    dev = keys[0].device
    if N == 0:
        empty = torch.empty((0,), dtype=torch.int32, device=dev)
        return (empty,) * (len(keys) + (1 if purge else 5)), empty
    if pay is None:
        skeys, sent, is_start, rows = packed_rows(keys, keymask)
        keys = tuple(keys[:-1]) + (narrow(torch.where(sent, 0xFFFFFFFF, skeys[-1])),)
    else:
        sent, is_start, rows = sep_rows(keys, pay)
    is_last = torch.cat([is_start[1:], torch.ones((1,), dtype=torch.bool, device=dev)])
    s = seg_sums_plain(rows, is_start, MAX_KMER_COUNT)
    count = s[0]
    if purge:
        lcall = get_ext_calls(torch.stack(s[1:5], 1), count, dmin_thres).to(torch.int64)
        rcall = get_ext_calls(torch.stack(s[5:9], 1), count, dmin_thres).to(torch.int64)
        keep = is_last & ~sent & (count >= 2) & ~((lcall == EXT_X) & (rcall == EXT_X))
        data = keys + (narrow(count | (lcall << 16) | (rcall << 24)),)
    else:
        keep = is_last & ~sent
        data = keys + (narrow(count),) + tuple(
            narrow(s[i] | (s[i + 1] << 16)) for i in (1, 3, 5, 7))
    flags = torch.where(keep, 0, 1).to(torch.int32)
    return data, flags


def _scan_purge_cuda(keys, pay, keymask: int, dmin_thres: int, purge: bool):
    lanes = keys + (() if pay is None else (pay,))
    for i, x in enumerate(lanes):
        kernels.require(x, torch.int32, f"finalize lane {i}")
    weff = len(keys)
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
        kernels.ptrs(lanes), weff, int(pay is not None), N, keymask, dmin_thres, int(purge),
        kernels.ptrs(data),
        flags.data_ptr(), agg_f.data_ptr(), agg_v.data_ptr(), carry.data_ptr(),
        kernels.stream(dev),
    )
    kernels.check(rc, "finalize")
    kernels.count_launch("finalize")
    return data, flags
