"""finalize: group sums, extension calls, purge and compaction of a merged
sorted raw run into the final table (port of
mhm2_proxy_tpu/ops/pallas_finalize.py and the ragged_append after it).

scan_purge_compact(lanes, k, W, dmin_thres, purge, pay) -> (words,
*payload lanes, n_kept). The run is packed (payload in the last key lane's
free bits) or, with `pay`, key lanes plus a separate payload lane (k = 63,
77). A group's last row is kept unless it is a sentinel and, with purge,
unless its count (clamped at MAX_KMER_COUNT) is below 2 or both its
extension calls are X. The kept rows come out in order: words (N, W) int32
(the key lanes, payload bits cleared, then zero columns; all-ones past the
count), then one packed (count | lcall<<16 | rcall<<24) lane (purge) or
the five ops/count.py::_pack_sums lanes of the group sums (no purge), zero
past the count, and n_kept as a 0-dim int32 tensor. The CUDA kernel is
csrc/finalize.cu, one launch; the plain version follows the reference's
XLA branches of final_from_sorted_packed and final_from_sorted_sep
(count.py:1104-1137, 1186-1208): the group sums of ops/scan.py's plain
version, elementwise calls, then compact.py's plain gather.
"""

from __future__ import annotations

import torch

from ..constants import EXT_F, EXT_X, MAX_KMER_COUNT
from . import kernels
from .compact import _compact_plain, words_layout
from .scan import TILE_ROWS, VALUE_WORDS, packed_rows, seg_sums_plain, sep_rows
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


def scan_purge_compact(sorted_lanes, k: int, W: int, dmin_thres: int = 2, purge: bool = True,
                       pay=None):
    """pay: None for the packed layout, else the separate payload lane
    (count | left<<16 | right<<24, 0 on sentinel rows) of a key-sorted run
    whose weff lanes are all key (k = 63, 77). W: the table's words a row
    (words32_for_k(k))."""
    keys = tuple(sorted_lanes)
    if pay is None:
        keymask = _keymask(k, len(keys))
    elif len(keys) != -(-2 * k // 32):
        raise ValueError(f"finalize: k={k} has {-(-2 * k // 32)} key lanes, got {len(keys)}")
    else:
        keymask = 0xFFFFFFFF
    if not len(keys) <= W <= 8 or W % 2:
        raise ValueError(f"finalize: {W} words a row for {len(keys)} key lanes")
    if kernels.use_kernel(*keys, *(() if pay is None else (pay,))):
        return _scan_purge_compact_cuda(keys, pay, keymask, W, dmin_thres, purge)
    return _scan_purge_compact_plain(keys, pay, keymask, W, dmin_thres, purge)


def _scan_purge_compact_plain(keys, pay, keymask: int, W: int, dmin_thres: int, purge: bool):
    data, keep = _scan_purge_plain(keys, pay, keymask, dmin_thres, purge)
    layout, fills = words_layout(W, len(data) - len(keys), len(keys))
    (out,), counts = _compact_plain(data, keep, (0,), (layout,), (fills,))
    return out + (counts[0],)


def _scan_purge_plain(keys, pay, keymask: int, dmin_thres: int, purge: bool):
    """Every row's data lanes (keys with the payload bits cleared and
    sentinel rows all-ones, then the packed lane(s) of its inclusive group
    sums) and whether it is kept."""
    N = keys[0].shape[0]
    dev = keys[0].device
    if N == 0:
        empty = torch.empty((0,), dtype=torch.int32, device=dev)
        return (empty,) * (len(keys) + (1 if purge else 5)), empty.bool()
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
    return data, keep


def _scan_purge_compact_cuda(keys, pay, keymask: int, W: int, dmin_thres: int, purge: bool):
    lanes = keys + (() if pay is None else (pay,))
    for i, x in enumerate(lanes):
        kernels.require(x, torch.int32, f"finalize lane {i}")
    weff = len(keys)
    N = lanes[0].shape[0]
    dev = lanes[0].device
    if any(x.shape != (N,) for x in lanes):
        raise ValueError("finalize: every lane needs the same rows")
    n_pay = 1 if purge else 5
    words = torch.empty((N, W), dtype=torch.int32, device=dev)
    pays = torch.empty((n_pay, N), dtype=torch.int32, device=dev)
    count = torch.zeros((1,), dtype=torch.int32, device=dev)
    out = (words,) + tuple(pays[i] for i in range(n_pay))
    if N == 0:
        return out + (count[0],)
    T = -(-N // TILE_ROWS)
    # the sums' status words in the first half, the kept counts' in the second
    status, ticket, gen = kernels.look_back_scratch("finalize", dev, 2 * T)
    vals = torch.empty((T * VALUE_WORDS,), dtype=torch.int32, device=dev)
    rc = kernels.lib().mhm2_finalize(
        kernels.ptrs(lanes), weff, int(pay is not None), N, keymask, dmin_thres, int(purge), W,
        words.data_ptr(), kernels.ptrs(out[1:]), count.data_ptr(), status.data_ptr(),
        status.numel(), vals.data_ptr(), ticket.data_ptr(), gen, kernels.stream(dev),
    )
    kernels.check(rc, "finalize")
    kernels.count_launch("finalize")
    return out + (count[0],)
