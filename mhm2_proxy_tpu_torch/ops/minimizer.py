"""minimizer: the target shard of every k-mer position (port of
mhm2_proxy_tpu/ops/pallas_minimizer.py).

minimizer_targets(codes, k, m, n_shards): codes (B, L) uint8 -> (B, P)
int32, P = L-k+1, each position's quick_hash(minimizer) % n_shards
(reference kmer_dht.cpp:193-196): the greatest least-complement m-mer of the
window (N packs as G, bases past L are A), the 64-bit mix hash
(hash_funcs.c:332-342), the unsigned remainder. The CUDA kernel is
csrc/minimizer.cu (whole reads a block, a van Herk/Gil-Werman window
maximum, and u32 remainders from a reciprocal computed here); the plain
version is ops/bitkmer.py's u64 formulation.
"""

from __future__ import annotations

import torch

from . import kernels
from .bitkmer import minimizers_from_codes, quick_hash_u64
from .u64 import umod


def minimizer_targets(codes, k: int, m: int, n_shards: int):
    B, L = codes.shape
    if L < k or not 1 <= m <= min(k, 28):
        raise ValueError(f"minimizer: L={L}, k={k}, m={m}")
    # the reference's fold of the remainder is exact only while n^2 < 2^32
    if not 1 <= n_shards or n_shards * n_shards >= 1 << 32:
        raise ValueError(f"minimizer: n_shards={n_shards} needs n_shards^2 < 2^32")
    if kernels.use_kernel(codes):
        return _targets_cuda(codes, k, m, n_shards)
    return _targets_plain(codes, k, m, n_shards)


def _targets_plain(codes, k: int, m: int, n_shards: int):
    return umod(quick_hash_u64(minimizers_from_codes(codes, k, m)), n_shards).to(torch.int32)


def remainder_constants(n_shards: int) -> tuple[int, int]:
    """(M, 2^32 % n_shards) for the kernel's remainders: M = floor((2^64 -
    1) / n_shards) + 1 mod 2^64, with which a u32 a's remainder is the high
    64 bits of (M a mod 2^64) n_shards (Lemire, Kaser and Kurz 2019), exact
    for every u32 a; the hash's remainder folds its two halves'."""
    return (((1 << 64) - 1) // n_shards + 1) & ((1 << 64) - 1), (1 << 32) % n_shards


def _targets_cuda(codes, k: int, m: int, n_shards: int):
    kernels.require(codes, torch.uint8, "minimizer codes")
    B, L = codes.shape
    P = L - k + 1
    out = torch.empty((B, P), dtype=torch.int32, device=codes.device)
    if B * P == 0:
        return out
    recip, two32 = remainder_constants(n_shards)
    rc = kernels.lib().mhm2_minimizer(codes.data_ptr(), B, L, k, m, n_shards, recip, two32,
                                      out.data_ptr(), kernels.stream(codes.device))
    kernels.check(rc, "minimizer")
    kernels.count_launch("minimizer")
    return out
