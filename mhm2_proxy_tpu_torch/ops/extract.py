"""extract: k-mer record extraction (port of mhm2_proxy_tpu/ops/pallas_extract.py).

A block of reads (codes (B, L) uint8, qual_ok (B, L) bool, lens (B,) int32)
becomes sort-ready record lanes, one row per (read, position), flattened to
(B*P,) int32 lanes (P = L-k+1). Invalid rows carry the all-ones key
sentinel. The CUDA kernel is csrc/extract.cu; the plain version below is
the bitkmer formulation of ops/count.py::read_kmer_records +
pack_payload_into_lanes in the reference.
"""

from __future__ import annotations

import torch

from ..constants import EXT_NONE, words32_for_k
from . import kernels
from .bitkmer import canonicalize_words, kmer_words_from_codes
from .u32 import ONES, narrow


def extract_packed_lanes(codes, qual_ok, lens, k: int):
    """ceil(2k/32) lanes, the 7-bit payload (valid | left<<1 | right<<4) in
    the last lane's free low bits (requires count.payload_fits_in_keys)."""
    return _extract(codes, qual_ok, lens, k, packed=True)


def extract_record_lanes(codes, qual_ok, lens, k: int):
    """(W key lanes, payload lane): payload = 1 | left<<16 | right<<24 on
    valid rows, 0 on invalid rows (whose keys are all-ones)."""
    out = _extract(codes, qual_ok, lens, k, packed=False)
    return out[:-1], out[-1]


def _extract(codes, qual_ok, lens, k: int, packed: bool):
    if kernels.use_kernel(codes, qual_ok, lens):
        return _extract_cuda(codes, qual_ok, lens, k, packed)
    return _extract_plain(codes, qual_ok, lens, k, packed)


def _extract_cuda(codes, qual_ok, lens, k: int, packed: bool):
    kernels.require(codes, torch.uint8, "extract codes")
    kernels.require(qual_ok, torch.bool, "extract qual_ok")
    kernels.require(lens, torch.int32, "extract lens")
    B, L = codes.shape
    if qual_ok.shape != codes.shape or lens.shape != (B,):
        raise ValueError(f"extract: shapes {codes.shape} {qual_ok.shape} {lens.shape}")
    W = words32_for_k(k)
    n_out = -(-2 * k // 32) if packed else W + 1
    P = L - k + 1
    out = torch.empty((n_out, B * P), dtype=torch.int32, device=codes.device)
    lanes = tuple(out[i] for i in range(n_out))
    lib = kernels.lib()
    rc = lib.mhm2_extract(
        codes.data_ptr(), qual_ok.view(torch.uint8).data_ptr(), lens.data_ptr(),
        B, L, k, int(packed), kernels.ptrs(lanes), n_out, kernels.stream(codes.device),
    )
    kernels.check(rc, "extract")
    if B * P:
        kernels.count_launch("extract")
    return lanes


def _extract_plain(codes, qual_ok, lens, k: int, packed: bool):
    B, L = codes.shape
    P = L - k + 1
    W = words32_for_k(k)
    cwords, was_rc = canonicalize_words(kmer_words_from_codes(codes, k), k)
    c = codes.to(torch.int64)
    ext = torch.where(qual_ok & (c < 4), c, EXT_NONE)
    # left ext of kmer i is base i-1; right ext is base i+k
    left = torch.nn.functional.pad(ext[:, : P - 1], (1, 0), value=EXT_NONE)
    right = torch.nn.functional.pad(ext, (0, k + 1), value=EXT_NONE)[:, k : k + P]
    comp = lambda e: torch.where(e < 4, 3 - e, e)  # noqa: E731
    left_c = torch.where(was_rc, comp(right), left).reshape(-1)
    right_c = torch.where(was_rc, comp(left), right).reshape(-1)
    pos = torch.arange(P, device=codes.device)[None, :]
    valid = ((pos >= 1) & (pos <= lens.to(torch.int64)[:, None] - k - 1)).reshape(-1)
    cw = cwords.reshape(B * P, W)
    if packed:
        weff = -(-2 * k // 32)
        pay7 = narrow(1 | (left_c << 1) | (right_c << 4))
        lanes = [cw[:, w] for w in range(weff - 1)] + [cw[:, weff - 1] | pay7]
        return tuple(torch.where(valid, x, ONES).contiguous() for x in lanes)
    pay = narrow(1 | (left_c << 16) | (right_c << 24))
    return tuple(torch.where(valid, cw[:, w], ONES).contiguous() for w in range(W)) + (
        torch.where(valid, pay, 0),
    )
