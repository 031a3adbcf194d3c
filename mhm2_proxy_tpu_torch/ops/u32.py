"""u32 lanes held in torch.int32 tensors.

torch's uint32 has no shifts, compares or additions on the CPU, and torch
has no multi-key sort. The port therefore stores every u32 lane as int32
with the reference's exact bit pattern (the CUDA kernels read uint32_t*
over those bytes) and plain code widens to int64 for unsigned arithmetic.
In the lexsort below the all-ones sentinel sorts last and keys with bit 31
set sort above the rest, exactly as the reference's unsigned order.
"""

from __future__ import annotations

import torch

ONES = -1  # the all-ones u32 sentinel as int32
_M32 = 0xFFFFFFFF


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 (u32 bits) -> int64 holding the unsigned value."""
    return x.to(torch.int64) & _M32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a value in [0, 2^32) (higher bits ignored) -> int32
    with the same low 32 bits."""
    return (((x & _M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def u32(v: int) -> int:
    """A python u32 constant as the int32 value with the same bits."""
    v &= _M32
    return v - (1 << 32) if v >= (1 << 31) else v


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """One int64 whose signed order is the unsigned order of (hi, lo)."""
    return (widen(hi) - (1 << 31)) * (1 << 32) + widen(lo)


def lexsort_perm(lanes) -> torch.Tensor:
    """Stable permutation sorting rows by the given u32 lanes (lane 0 most
    significant, unsigned). LSD over pairs of lanes fused into int64 keys."""
    lanes = list(lanes)
    n = lanes[0].shape[0]
    perm = torch.arange(n, device=lanes[0].device)
    groups = []
    i = len(lanes)
    while i >= 2:
        groups.append((lanes[i - 2], lanes[i - 1]))
        i -= 2
    if i == 1:
        groups.append((lanes[0],))
    for g in groups:  # least significant group first
        key = _pair_key(*g) if len(g) == 2 else widen(g[0])
        order = torch.sort(key[perm], stable=True).indices
        perm = perm[order]
    return perm


def lexsort_lanes(lanes, kw: int | None = None):
    """Stable sort of a tuple of lanes by its first kw lanes (all lanes by
    default); returns the permuted tuple."""
    lanes = tuple(lanes)
    kw = len(lanes) if kw is None else kw
    perm = lexsort_perm(lanes[:kw])
    return tuple(x[perm] for x in lanes)


def rows_equal_next(lanes) -> torch.Tensor:
    """(N-1,) bool: row i equals row i+1 on every lane."""
    eq = None
    for x in lanes:
        e = x[1:] == x[:-1]
        eq = e if eq is None else (eq & e)
    return eq
