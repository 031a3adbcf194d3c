"""Supermer-packed exchange records (port of mhm2_proxy_tpu/ops/supermer.py).

The reference ships each maximal run of consecutive same-owner k-mers as one
(k + len)-base string instead of len separate k-mers, its ~k x cut of the
all-to-all volume (kcount_cpu.cpp:84-103, Supermer pack/unpack
kmer_dht.cpp:70-103). Records have a fixed width:

  record = [code words: 2 bits a base, MSB first, N folded to G]
           [mask words: 1 bit a base, ext-valid (high quality, not N)]
           [meta word:  k-mer count n (8 bits) | depth (16 bits) | spare (8)]

covering up to smax k-mers (longer runs split). A record carries bases
i0 - 1 .. i0 + n - 1 + k of its read, the window whose positions 1..n are
the counted k-mers with both extensions, so the receiver replays
read_kmer_records on the unpacked windows. u32 words are held in int32
tensors (ops/u32.py). Plain torch: the routing runs the minimizer kernel,
the receiver the extract kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import MAX_KMER_COUNT, minimizer_len_for_k
from .count import minimizer_shard_targets
from .u32 import narrow, widen

# k-mers a record at most (the reference's default; a record spans
# k + 1 + SMAX bases)
SMAX = 24


def supermer_layout(k: int, smax: int):
    """(bases a window, code words, mask words, words a record)."""
    nb = k + 1 + smax
    cw = (nb + 15) // 16
    mw = (nb + 31) // 32
    return nb, cw, mw, cw + mw + 1


def _runs(codes, lens, k: int, smax: int, n_shards: int):
    """Per position of a (B, L) block: valid (a counted k-mer), its owner
    shard, seg_start (a record starts here) and n_seg (its k-mers there)."""
    B, L = codes.shape
    P = L - k + 1
    dev = codes.device
    pos = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    valid = (pos >= 1) & (pos <= lens.to(torch.int32)[:, None] - k - 1)
    target = minimizer_shard_targets(codes, k, minimizer_len_for_k(k), n_shards)
    prev_valid = F.pad(valid[:, :-1], (1, 0))
    prev_target = F.pad(target[:, :-1], (1, 0), value=-1)
    run_break = valid & (~prev_valid | (target != prev_target))
    # the start of each position's run: a running max of the break positions
    run_start = torch.cummax(torch.where(run_break, pos, -1), dim=1).values
    seg_start = valid & ((pos - run_start) % smax == 0)
    del run_break, run_start, prev_valid, prev_target
    # the end of each position's run: a running min, from the right, of the
    # positions whose next position does not continue the run
    cont_next = F.pad(valid[:, 1:] & valid[:, :-1] & (target[:, 1:] == target[:, :-1]), (0, 1))
    stop_at = torch.where(cont_next, 1 << 30, pos)
    run_end = torch.flip(torch.cummin(torch.flip(stop_at, (1,)), dim=1).values, (1,))
    n_seg = torch.clamp(run_end - pos + 1, max=smax)
    return valid, target, seg_start, n_seg


def _pack_bits(vals, per_word: int, bits: int, msb_first: bool):
    """(M, nb) small ints -> (M, ceil(nb / per_word)) int32 words."""
    M, nb = vals.shape
    n_words = (nb + per_word - 1) // per_word
    v = F.pad(vals, (0, n_words * per_word - nb)).view(M, n_words, per_word)
    acc = torch.zeros((M, n_words), dtype=torch.int64, device=vals.device)
    for j in range(per_word):
        shift = bits * (per_word - 1 - j) if msb_first else bits * j
        acc |= v[:, :, j].to(torch.int64) << shift
    return narrow(acc)


def build_supermers(codes, qual_ok, lens, k: int, smax: int, n_shards: int, depth=None,
                    n_src: int = 1):
    """Cut a block of reads into supermer records routed by minimizer hash.

    codes (n_src * B, L) uint8, qual_ok bool, lens int32; rows
    [s * B, (s + 1) * B) are source s's reads; depth optional (n_src * B,)
    per-sequence count (contig pass). Only the reference's valid rows (a
    run's segment starts) are built, each source's in position order:
    records (n_src, N, R) int32 (u32 bits), target (n_src, N) int32,
    valid (n_src, N) bool (False on the padding up to the fullest source's
    N), row (n_src, N) int64 (the record's position b * P + p within its
    source, -1 on padding), and n_kmers (the block's counted k-mers)."""
    SB, L = codes.shape
    B, P = SB // n_src, L - k + 1
    nb, cw, mw, R = supermer_layout(k, smax)
    dev = codes.device
    valid, target, seg_start, n_seg = _runs(codes, lens, k, smax, n_shards)
    n_kmers = int(valid.sum())
    del valid
    seg = seg_start.view(n_src, B * P)
    counts = seg.sum(1)
    N = max(1, int(counts.max()))
    src, row = seg.nonzero(as_tuple=True)
    del seg, seg_start
    first = torch.cumsum(counts, 0) - counts
    dest = src * N + torch.arange(src.shape[0], device=dev) - first[src]
    b, p = src * B + row // P, row % P
    # the nb-base windows of the record rows only: a strided view of the
    # padded block, gathered at (b, p - 1)
    in_read = (p[:, None] - 1 + torch.arange(nb, device=dev)[None, :]
               < lens[b].to(torch.int64)[:, None])
    wc = F.pad(codes, (0, nb)).unfold(1, nb, 1)[b, p - 1]
    wq = F.pad(qual_ok, (0, nb)).unfold(1, nb, 1)[b, p - 1]
    wmask = wq & (wc < 4) & in_read
    wc = torch.where(in_read, wc, 0)
    wc = torch.where(wc >= 4, 2, wc)  # N -> G, as the k-mer packing does
    del wq, in_read
    cnt = (torch.ones_like(b, dtype=torch.int64) if depth is None
           else torch.clamp(depth.to(torch.int64)[b], 0, MAX_KMER_COUNT))
    meta = narrow(n_seg[b, p].to(torch.int64) | (cnt << 8))
    records = torch.zeros((n_src * N, R), dtype=torch.int32, device=dev)
    records[dest] = torch.cat([_pack_bits(wc, 16, 2, True), _pack_bits(wmask, 32, 1, False),
                               meta[:, None]], dim=1)
    out_target = torch.zeros((n_src * N,), dtype=torch.int32, device=dev)
    out_target[dest] = target[b, p]
    out_valid = torch.zeros((n_src * N,), dtype=torch.bool, device=dev)
    out_valid[dest] = True
    out_row = torch.full((n_src * N,), -1, dtype=torch.int64, device=dev)
    out_row[dest] = row
    return dict(records=records.view(n_src, N, R), target=out_target.view(n_src, N),
                valid=out_valid.view(n_src, N), row=out_row.view(n_src, N), n_kmers=n_kmers)


def record_kmers(records, k: int, smax: int):
    """(N, R) records -> (N,) int32 k-mer counts n (0 on empty records)."""
    _nb, cw, mw, _R = supermer_layout(k, smax)
    return records[:, cw + mw] & 0xFF


def expand_supermers(records, k: int, smax: int):
    """(N, R) records -> (codes (N, nb) uint8, qual_ok (N, nb) bool, lens
    (N,) int32, depth (N,) int32). lens = n + k + 1, so that
    read_kmer_records counts exactly the record's n k-mers (positions 1..n
    of the window); empty records get lens 0."""
    nb, cw, mw, _R = supermer_layout(k, smax)
    N = records.shape[0]
    dev = records.device
    meta = records[:, cw + mw]
    n = meta & 0xFF
    depth = (meta >> 8) & 0xFFFF
    code_shift = 2 * (15 - torch.arange(16, device=dev))
    codes = ((widen(records[:, :cw])[:, :, None] >> code_shift) & 3).view(N, cw * 16)[:, :nb]
    bit_shift = torch.arange(32, device=dev)
    qual_ok = ((widen(records[:, cw:cw + mw])[:, :, None] >> bit_shift) & 1).view(N, mw * 32)
    lens = torch.where(n > 0, n + k + 1, 0).to(torch.int32)
    return (codes.to(torch.uint8).contiguous(), qual_ok[:, :nb].bool().contiguous(), lens,
            depth.to(torch.int32))
