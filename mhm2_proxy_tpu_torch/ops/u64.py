"""u64 values held in torch.int64 tensors.

torch's uint64 has no shifts or compares on the CPU, so, as ops/u32.py does
for u32 lanes, the plain code holds every u64 as the int64 with the same bit
pattern. Multiply, add, xor and left shifts wrap the same way in both types;
the helpers below supply what differs: the logical right shift, unsigned
order (bit 63 flipped before a signed compare) and the unsigned remainder.
"""

from __future__ import annotations

import torch

_SIGN = -(1 << 63)  # bit 63 as int64


def i64(v: int) -> int:
    """A python u64 constant as the int64 value with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of u64 bits by a constant 0 <= n < 64."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (64 - n)) - 1)


def umax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned max."""
    return torch.maximum(a ^ _SIGN, b ^ _SIGN) ^ _SIGN


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned min."""
    return torch.minimum(a ^ _SIGN, b ^ _SIGN) ^ _SIGN


def umod(x: torch.Tensor, n: int) -> torch.Tensor:
    """Unsigned remainder of u64 bits by 1 <= n < 2^31, as int64: the (hi, lo)
    fold of mhm2_proxy_tpu/ops/pallas_minimizer.py:167-173, exact in int64
    (the fold's sum is below n^2 + n)."""
    if not 1 <= n < (1 << 31):
        raise ValueError(f"umod: modulus {n} out of range")
    hi = shr(x, 32)
    lo = x & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n
