"""In-memory packed read storage (reference src/packed_reads.{hpp,cpp}).

Reads live in fixed-shape numpy blocks (codes (B, L) uint8 0-3/4=N, raw
phred quals, lengths) — the dense-array analog of the reference's PackedRead
list (1 byte/base, packed_reads.cpp:85-107). Blocks are re-chunked into the
caller's requested (block_reads, pad_len) shape with vectorized copies, so
ingest and counting never touch individual reads in Python. Counting takes
its blocks from count_blocks(), built once for every round of a job.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bitkmer import ascii_to_codes
from ..utils import trace


class PackedReads:
    def __init__(self, qual_offset: int = 33):
        self.qual_offset = qual_offset
        self._blocks: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        self.max_read_len = 0
        self._n_reads = 0
        self._total_bases = 0
        self._rows = 0  # every row of the blocks, placeholders too
        self._count: _CountBlocks | None = None

    def add_block(self, codes: np.ndarray, quals: np.ndarray, lens: np.ndarray,
                  n_valid: int | None = None, ids: np.ndarray | None = None):
        """Adopt a padded (B, L) block; rows with len 0 are placeholders.

        ids: signed int64 read ids (reference packed_reads.cpp:74-75:
        magnitude shared by mates, sign - for mate 1 / + for mate 2;
        merged and unpaired reads carry the mate-1 id). Rows without a
        caller-assigned id get 0 (anonymous)."""
        if n_valid is not None:
            codes, quals, lens = codes[:n_valid], quals[:n_valid], lens[:n_valid]
            if ids is not None:
                ids = ids[:n_valid]
        lens = np.asarray(lens, np.int32)
        if ids is None:
            ids = np.zeros((len(lens),), np.int64)
        self._blocks.append(
            (np.asarray(codes, np.uint8), np.asarray(quals, np.uint8), lens,
             np.asarray(ids, np.int64))
        )
        if len(lens):
            self.max_read_len = max(self.max_read_len, int(lens.max()))
        self._n_reads += int((lens > 0).sum())
        self._total_bases += int(lens.sum())
        self._rows += len(lens)
        self._count = None

    def add_read(self, seq: bytes | str, quals: bytes | str):
        if isinstance(seq, str):
            seq = seq.encode()
        if isinstance(quals, str):
            quals = quals.encode()
        n = len(seq)
        codes = ascii_to_codes(seq)[None, :]
        q = np.frombuffer(quals, np.uint8)[None, :]
        self.add_block(codes, q, np.array([n], np.int32))

    # compat helper for tests that append per-read
    def add_batch(self, codes, quals, lens):
        self.add_block(np.asarray(codes), np.asarray(quals), np.asarray(lens))

    def __len__(self):
        return self._n_reads

    @property
    def total_bases(self):
        return self._total_bases

    def blocks(self, block_reads: int, pad_len: int | None = None, min_len: int = 0,
               with_ids: bool = False):
        """Yield fixed-shape (codes (B,L), quals (B,L), lens (B,)) blocks.

        Reads shorter than min_len keep their row but get len 0 (masked out
        downstream), preserving static shapes. The final block is padded.
        with_ids appends the signed int64 read-id lane.
        """
        L = pad_len or max(self.max_read_len, 1)

        def fresh():
            return (
                np.full((block_reads, L), 4, np.uint8),
                np.zeros((block_reads, L), np.uint8),
                np.zeros((block_reads,), np.int32),
                np.zeros((block_reads,), np.int64),
            )

        out_c, out_q, out_l, out_i = fresh()
        cur = 0
        emitted = False
        for codes, quals, lens, ids in self._blocks:
            nb, Lb = codes.shape
            Lc = min(Lb, L)
            pos = 0
            while pos < nb:
                take = min(nb - pos, block_reads - cur)
                out_c[cur : cur + take, :Lc] = codes[pos : pos + take, :Lc]
                out_q[cur : cur + take, :Lc] = quals[pos : pos + take, :Lc]
                ls = np.minimum(lens[pos : pos + take], L)
                out_l[cur : cur + take] = np.where(ls >= max(min_len, 1), ls, 0)
                out_i[cur : cur + take] = ids[pos : pos + take]
                cur += take
                pos += take
                if cur == block_reads:
                    yield (out_c, out_q, out_l, out_i) if with_ids else (out_c, out_q, out_l)
                    emitted = True
                    out_c, out_q, out_l, out_i = fresh()
                    cur = 0
        if cur > 0 or not emitted:
            yield (out_c, out_q, out_l, out_i) if with_ids else (out_c, out_q, out_l)

    def n_blocks(self, block_reads: int) -> int:
        """How many blocks blocks(block_reads) yields."""
        return max(1, -(-self._rows // block_reads))

    def count_blocks(self, block_reads: int, pad_len: int, qual_cut: int, min_len: int = 0,
                     n_blocks: int = 0, pin: bool = False):
        """Yield counting blocks (codes (B, L) uint8 and qual_ok (B, L) bool
        CPU tensors, lens (B,) int32): blocks(block_reads, pad_len, min_len)
        with quals >= qual_cut for the quals, then all-4 / all-false / zero
        blocks up to n_blocks.

        The codes and masks are built once, one tensor each a block (pinned
        with pin, for copies to a card that need not block), and served
        again to later calls: min_len changes only the lengths, and a
        block_reads that divides the built blocks' rows takes row slices of
        them. Another pad_len or cut rebuilds; add_block drops them. They
        are never written once built. Counts built_bytes and reused_blocks
        on the innermost span."""
        c = self._count
        if (c is None or c.L != pad_len or c.cut != qual_cut or c.pin != pin
                or c.rows % block_reads):
            c = self._count = _CountBlocks(self, block_reads, pad_len, qual_cut, pin)
        per = c.rows // block_reads
        n_mine = self.n_blocks(block_reads)
        floor = max(min_len, 1)
        for j in range(max(n_mine, n_blocks)):
            blk = c.block(j // per) if j < n_mine else c.padding()
            off = j % per * block_reads if j < n_mine else 0
            codes, ok, ls = (a[off : off + block_reads] for a in blk)
            yield codes, ok, np.where(ls >= floor, ls, 0)

    def release_count_blocks(self):
        """Drop count_blocks()'s blocks (their pinned pages go back to
        torch's host allocator, for the next job's)."""
        self._count = None

    def id_span(self):
        """(min, max) absolute read id over all assigned rows, or None.

        Feeds the cross-process disjointness check (the analog of the
        reference's neighbor-rank read-id validation, merge_reads.cpp:542-570).
        """
        lo = hi = None
        for _, _, lens, ids in self._blocks:
            a = np.abs(ids[(lens > 0) & (ids != 0)])
            if a.size:
                lo = int(a.min()) if lo is None else min(lo, int(a.min()))
                hi = int(a.max()) if hi is None else max(hi, int(a.max()))
        return None if lo is None else (lo, hi)

    def qual_ok(self, quals: np.ndarray, cutoff: int = 20) -> np.ndarray:
        """phred >= cutoff mask (reference kcount.cpp:80-85)."""
        return quals >= (self.qual_offset + cutoff)


class _CountBlocks:
    """count_blocks()'s blocks of one shape, each built on its first use:
    rows [i * rows, (i + 1) * rows) of the reads' blocks as codes padded
    with 4, the quality cut's mask, and lengths cut to L."""

    def __init__(self, reads: PackedReads, rows: int, L: int, cut: int, pin: bool):
        self.src = reads._blocks
        self.rows, self.L, self.cut, self.pin = rows, L, cut, pin
        self.starts = np.cumsum([0] + [len(b[2]) for b in self.src])
        self.built: dict[int, tuple] = {}
        self.empty = None

    def _new(self):
        """An all-4 / all-false / zero block, its bytes counted as built."""
        codes = torch.full((self.rows, self.L), 4, dtype=torch.uint8, pin_memory=self.pin)
        ok = torch.zeros((self.rows, self.L), dtype=torch.bool, pin_memory=self.pin)
        lens = np.zeros((self.rows,), np.int32)
        trace.count("built_bytes", codes.nbytes + ok.nbytes + lens.nbytes)
        return codes, ok, lens

    def block(self, i: int):
        blk = self.built.get(i)
        if blk is not None:
            trace.count("reused_blocks")
            return blk
        blk = self.built[i] = self._new()
        codes, ok, lens = blk[0].numpy(), blk[1].numpy(), blk[2]
        lo, hi = i * self.rows, (i + 1) * self.rows
        first = int(np.searchsorted(self.starts, lo, side="right")) - 1
        for b in range(first, len(self.src)):
            s0 = int(self.starts[b])
            if s0 >= hi:
                break
            c, q, ln, _ = self.src[b]
            a, z = max(lo, s0), min(hi, s0 + len(ln))
            if a >= z:
                continue
            w = min(c.shape[1], self.L)
            d, s = slice(a - lo, z - lo), slice(a - s0, z - s0)
            codes[d, :w] = c[s, :w]
            np.greater_equal(q[s, :w], self.cut, out=ok[d, :w])
            lens[d] = np.minimum(ln[s], self.L)
        return blk

    def padding(self):
        if self.empty is None:
            self.empty = self._new()
        else:
            trace.count("reused_blocks")
        return self.empty
