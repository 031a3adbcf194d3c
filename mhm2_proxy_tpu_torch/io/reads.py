"""In-memory packed read storage (reference src/packed_reads.{hpp,cpp}).

Reads live in fixed-shape numpy blocks (codes (B, L) uint8 0-3/4=N, raw
phred quals, lengths) — the dense-array analog of the reference's PackedRead
list (1 byte/base, packed_reads.cpp:85-107). Blocks are re-chunked into the
caller's requested (block_reads, pad_len) shape with vectorized copies, so
ingest and counting never touch individual reads in Python.
"""

from __future__ import annotations

import numpy as np

from ..ops.bitkmer import ascii_to_codes


class PackedReads:
    def __init__(self, qual_offset: int = 33):
        self.qual_offset = qual_offset
        self._blocks: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        self.max_read_len = 0
        self._n_reads = 0
        self._total_bases = 0

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
