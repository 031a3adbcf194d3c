"""2-bit k-mer packing on torch tensors (port of mhm2_proxy_tpu/ops/bitkmer.py).

K-mers are (..., W) u32 words in [hi0, lo0, hi1, lo1, ...] order, i.e. the
reference's big-endian 2-bit uint64 packing (reference src/kmer.cpp:298-320)
split into 32-bit halves, so lexicographic comparison over the words equals
the reference's uint64-array comparison. Base codes: A=0 C=1 G=2 T=3, N=4
(N packs as G, src/kmer.cpp:169). Words are stored as int32 (ops/u32.py);
the functions here widen to int64 internally.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import words32_for_k
from .u32 import narrow, widen

_M32 = 0xFFFFFFFF

_ASCII_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _ASCII_CODE[ord(_c)] = _i
    _ASCII_CODE[ord(_c.lower())] = _i


def ascii_to_codes(buf: np.ndarray | bytes) -> np.ndarray:
    """Host helper: ASCII bytes -> base codes uint8 (0-3, N/other=4)."""
    a = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) else np.asarray(buf, np.uint8)
    return _ASCII_CODE[a]


def _endmasks(k: int, W: int) -> list[int]:
    """Per-word masks zeroing 2-bit fields beyond base k-1."""
    masks = []
    for w in range(W):
        nb = min(max(k - 16 * w, 0), 16)
        masks.append((((1 << (2 * nb)) - 1) << (32 - 2 * nb)) & _M32 if nb else 0)
    return masks


def kmer_words_from_codes(codes: torch.Tensor, k: int) -> torch.Tensor:
    """(..., L) uint8 base codes -> (..., P, W) int32 k-mer words, P = L-k+1.

    Windows crossing the true sequence end produce don't-care words; callers
    mask with their own validity (reference kmer.cpp:165-257)."""
    L = codes.shape[-1]
    P = L - k + 1
    assert P >= 1, f"L={L} < k={k}"
    W = words32_for_k(k)
    n_chunks = (k + 15) // 16
    c = codes.to(torch.int64)
    c = torch.where(c >= 4, 2, c)  # N packs as G
    pad = 16 * (n_chunks - 1) + 15 + 16
    c = torch.nn.functional.pad(c, (0, pad))
    out_len = P + 16 * (n_chunks - 1)
    v = torch.zeros(codes.shape[:-1] + (out_len,), dtype=torch.int64, device=codes.device)
    for j in range(16):
        v = (v << 2) | c[..., j : j + out_len]
    masks = _endmasks(k, W)
    words = []
    for w in range(W):
        if masks[w] == 0:
            words.append(torch.zeros(codes.shape[:-1] + (P,), dtype=torch.int64, device=codes.device))
        else:
            words.append(v[..., 16 * w : 16 * w + P] & masks[w])
    return narrow(torch.stack(words, dim=-1))


def _rev2bits32(v: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit fields of each u32 (int64 holding the value)."""
    v = ((v & 0x33333333) << 2) | ((v >> 2) & 0x33333333)
    v = ((v & 0x0F0F0F0F) << 4) | ((v >> 4) & 0x0F0F0F0F)
    v = ((v & 0x00FF00FF) << 8) | ((v >> 8) & 0x00FF00FF)
    return ((v << 16) | (v >> 16)) & _M32


def _shift_left_words(w64: torch.Tensor, bits: int) -> torch.Tensor:
    """Funnel-shift (..., W) big-endian u32 words (int64) left by `bits`."""
    W = w64.shape[-1]
    word_shift, bit_shift = divmod(bits, 32)
    zero = torch.zeros_like(w64[..., 0])
    out = []
    for w in range(W):
        src = w + word_shift
        cur = w64[..., src] if src < W else zero
        if bit_shift:
            nxt = w64[..., src + 1] if src + 1 < W else zero
            cur = ((cur << bit_shift) | (nxt >> (32 - bit_shift))) & _M32
        out.append(cur)
    return torch.stack(out, dim=-1)


def _revcomp64(w64: torch.Tensor, k: int) -> torch.Tensor:
    W = w64.shape[-1]
    rev = _rev2bits32((w64 ^ _M32).flip(-1))
    shifted = _shift_left_words(rev, 32 * W - 2 * k)
    masks = torch.tensor(_endmasks(k, W), dtype=torch.int64, device=w64.device)
    return shifted & masks


def revcomp_words(words: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers (reference kmer.cpp:486-505)."""
    return narrow(_revcomp64(widen(words), k))


def _lex_less64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    W = a.shape[-1]
    lt = a[..., W - 1] < b[..., W - 1]
    for w in range(W - 2, -1, -1):
        lt = (a[..., w] < b[..., w]) | ((a[..., w] == b[..., w]) & lt)
    return lt


def canonicalize_words(words: torch.Tensor, k: int):
    """(min(kmer, revcomp) wordwise, was_rc) (reference kcount_cpu.cpp:326-332)."""
    w64 = widen(words)
    rc = _revcomp64(w64, k)
    was_rc = _lex_less64(rc, w64)
    return narrow(torch.where(was_rc[..., None], rc, w64)), was_rc


def forward_base_words(words: torch.Tensor, base: torch.Tensor, k: int) -> torch.Tensor:
    """kmer[1:] + base (reference kmer.cpp:513-523)."""
    shifted = _shift_left_words(widen(words), 2)
    w, fld = (k - 1) // 16, (k - 1) % 16
    ins = (base.to(torch.int64) & 3) << (2 * (15 - fld))
    shifted[..., w] = shifted[..., w] | ins
    return narrow(shifted)


def backward_base_words(words: torch.Tensor, base: torch.Tensor, k: int) -> torch.Tensor:
    """base + kmer[:-1] (reference kmer.cpp:526-537)."""
    w64 = widen(words)
    W = w64.shape[-1]
    out = []
    for w in range(W):
        cur = w64[..., w] >> 2
        if w > 0:
            cur = cur | ((w64[..., w - 1] << 30) & _M32)
        out.append(cur)
    masks = torch.tensor(_endmasks(k, W), dtype=torch.int64, device=words.device)
    shifted = torch.stack(out, dim=-1) & masks
    shifted[..., 0] = shifted[..., 0] | ((base.to(torch.int64) & 3) << 30)
    return narrow(shifted)


def first_base(words: torch.Tensor) -> torch.Tensor:
    """Code of base 0 as int64 (reference kmer.cpp:540-548)."""
    return (widen(words[..., 0]) >> 30) & 3


def last_base(words: torch.Tensor, k: int) -> torch.Tensor:
    """Code of base k-1 as int64 (reference kmer.cpp:550-562)."""
    w, fld = (k - 1) // 16, (k - 1) % 16
    return (widen(words[..., w]) >> (2 * (15 - fld))) & 3


# ---------------------------------------------------------------------------
# host conversion utilities (numpy; tests / IO)
# ---------------------------------------------------------------------------


def codes_from_words(words: np.ndarray, k: int) -> np.ndarray:
    """(N, W) packed words (uint32 or int32 bits) -> (N, k) uint8 base codes."""
    words = np.asarray(words)
    words = words.view(np.uint32) if words.dtype == np.int32 else words.astype(np.uint32)
    words = words.reshape(-1, words.shape[-1])
    i = np.arange(k)
    shift = (2 * (15 - (i % 16))).astype(np.uint32)
    return ((words[:, i // 16] >> shift[None, :]) & 3).astype(np.uint8)


def decode_words_ascii(words: np.ndarray, k: int) -> np.ndarray:
    """(N, W) packed words -> (N, k) uint8 ASCII bases (vectorized numpy)."""
    return np.frombuffer(b"ACGT", np.uint8)[codes_from_words(words, k)]


def words_to_strings(words: np.ndarray, k: int) -> list[str]:
    chars = decode_words_ascii(words, k)
    return [row.tobytes().decode() for row in chars]
