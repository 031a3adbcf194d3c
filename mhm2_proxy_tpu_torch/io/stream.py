"""Bounded-memory streaming FASTQ ingest.

The reference never slurps inputs: each rank streams its byte range with
fadvise hints (src/fastq.cpp:457-475) so terabase inputs ingest in constant
memory. This module replaces the round-1 whole-file read with a chunked
stream: raw or gzip files are read in `chunk_bytes` pieces, cut at record
boundaries, parsed (native C++ parser when available), and re-batched into
uniform `block_reads`-row blocks. Peak buffering is ~2 chunks + 1 block
regardless of file size.

Byte ranges (multi-host ingest, fastq.cpp:399-455) are supported for raw
files: the stream resyncs its start to the next record boundary and owns
every record that *starts* before `hi` (reading past `hi` only to finish the
last record), so ranges partition the file exactly.
"""

from __future__ import annotations

import gzip

import numpy as np

from .fastq import _resync_offset, headers_from_chunk, normalize_fq_name, parse_fastq_bytes


def _last_record_end(buf: bytes) -> int:
    """Byte offset just past the last complete 4-line record in buf.

    Assumes buf starts at a record boundary (guaranteed by resync/cutting).
    """
    arr = np.frombuffer(buf, np.uint8)
    nl = np.nonzero(arr == ord("\n"))[0]
    nrec = len(nl) // 4
    if nrec == 0:
        return 0
    return int(nl[4 * nrec - 1]) + 1


class FastqStream:
    """Chunked record-complete byte stream over a FASTQ file (or byte range)."""

    def __init__(self, fname: str, chunk_bytes: int = 8 << 20,
                 byte_range: tuple[int, int] | None = None):
        self.fname = fname
        self.chunk_bytes = int(chunk_bytes)
        self.byte_range = byte_range
        self.max_buffered = 0  # bounded-memory accounting for tests
        if byte_range is not None and fname.endswith(".gz"):
            raise ValueError("byte ranges require an uncompressed file")

    def _resync_at(self, buf: bytes, pos: int) -> int:
        """First record boundary in buf scanning from pos, with FastqReader's
        exact semantics even at pos 0 (a leading sentinel byte defeats the
        start==0 shortcut so range endpoints partition the file precisely)."""
        return _resync_offset(b"x" + buf, pos + 1) - 1

    def chunks(self):
        gz = self.fname.endswith(".gz")
        f = gzip.open(self.fname, "rb") if gz else open(self.fname, "rb")
        try:
            lo, hi = self.byte_range or (0, None)
            tail = b""
            consumed = lo  # raw-file offset just past all bytes read so far
            if lo:
                f.seek(lo)
                # resync the start to the next record boundary after lo
                probe = f.read(self.chunk_bytes)
                consumed += len(probe)
                start = self._resync_at(probe, 0)
                while start >= len(probe) and len(probe) < (hi or 1 << 62) - lo:
                    more = f.read(self.chunk_bytes)
                    if not more:
                        break
                    probe += more
                    consumed += len(more)
                    start = self._resync_at(probe, 0)
                tail = probe[start:] if start < len(probe) else b""
            while True:
                buf_start = consumed - len(tail)  # file offset of tail/buf[0]
                data = f.read(self.chunk_bytes)
                eof = not data
                buf = tail + data
                consumed += len(data)
                self.max_buffered = max(self.max_buffered, len(buf))
                if hi is not None and consumed >= hi:
                    # own every record STARTING before hi: cut at the first
                    # boundary at/after hi, extending the buffer if the
                    # boundary (or the final record) runs past it
                    keep = hi - buf_start
                    while True:
                        b = self._resync_at(buf, max(keep, 0))
                        if b < len(buf) or eof:
                            break
                        data = f.read(self.chunk_bytes)
                        eof = not data
                        buf += data
                        consumed += len(data)
                        self.max_buffered = max(self.max_buffered, len(buf))
                    if b > 0:
                        yield buf[:b]
                    return
                cut = len(buf) if eof else _last_record_end(buf)
                if cut:
                    yield buf[:cut]
                if eof:
                    return
                tail = buf[cut:]
        finally:
            f.close()


class _Rebatcher:
    """Accumulate parsed row groups; emit uniform (block_reads, L) blocks.

    With with_ids, each group carries a (header matrix, header lens) sideband
    (headers_from_chunk format) that is re-batched in lockstep so callers can
    validate pair names per emitted block.
    """

    def __init__(self, block_reads: int, pad_quantum: int, qual_offset: int,
                 with_ids: bool = False):
        self.B = block_reads
        self.q = pad_quantum
        self.qoff = qual_offset
        self.with_ids = with_ids
        self.groups: list[tuple] = []
        self.rows = 0

    def add(self, codes, quals, lens, hdrs=None):
        if self.with_ids and hdrs is None:
            raise ValueError("with_ids requires header sidebands")
        self.groups.append((codes, quals, lens, hdrs))
        self.rows += codes.shape[0]

    def _emit(self, n: int):
        L = max(int(max(g[0].shape[1] for g in self.groups)), self.q)
        L = (L + self.q - 1) // self.q * self.q
        out_c = np.full((self.B, L), 4, np.uint8)
        out_q = np.full((self.B, L), self.qoff, np.uint8)
        out_l = np.zeros((self.B,), np.int32)
        if self.with_ids:
            HW = max(int(g[3][0].shape[1]) for g in self.groups)
            out_h = np.zeros((self.B, HW), np.uint8)
            out_hl = np.zeros((self.B,), np.int32)
        cur = 0
        rest: list[tuple] = []
        for c, q, l, h in self.groups:
            if cur >= n:
                rest.append((c, q, l, h))
                continue
            take = min(c.shape[0], n - cur)
            out_c[cur : cur + take, : c.shape[1]] = c[:take]
            out_q[cur : cur + take, : q.shape[1]] = q[:take]
            out_l[cur : cur + take] = l[:take]
            if self.with_ids:
                hm, hl = h
                out_h[cur : cur + take, : hm.shape[1]] = hm[:take]
                out_hl[cur : cur + take] = hl[:take]
            cur += take
            if take < c.shape[0]:
                rest.append(
                    (c[take:], q[take:], l[take:],
                     (h[0][take:], h[1][take:]) if self.with_ids else None)
                )
        self.groups = rest
        self.rows -= n
        if self.with_ids:
            return out_c, out_q, out_l, n, (out_h, out_hl)
        return out_c, out_q, out_l, n

    def full_blocks(self):
        while self.rows >= self.B:
            yield self._emit(self.B)

    def flush(self):
        if self.rows > 0:
            yield self._emit(self.rows)


def stream_fastq_blocks(fname: str, block_reads: int, pad_quantum: int = 32,
                        qual_offset: int = 33, chunk_bytes: int = 8 << 20,
                        byte_range: tuple[int, int] | None = None,
                        stream: FastqStream | None = None,
                        with_ids: bool = False):
    """Yield (codes (B,L) u8, quals (B,L) u8, lens (B,) i32, n) blocks.

    Exactly `block_reads` rows per block (last block partial, n < B), with
    bounded memory: ~2 chunks + 1 block live at any time. Drop-in equivalent
    of the round-1 whole-buffer parse (identical blocks modulo padding width).

    with_ids appends a (header_matrix (B,W) u8, header_lens (B,) i32)
    sideband per block (headers_from_chunk format) for pair-name validation;
    extraction is vectorized so the hot path stays loop-free.
    """
    from . import native

    st = stream or FastqStream(fname, chunk_bytes, byte_range)
    rb = _Rebatcher(block_reads, pad_quantum, qual_offset, with_ids=with_ids)
    use_native = native.native_available()
    for chunk in st.chunks():
        hdrs = headers_from_chunk(chunk) if with_ids else None
        hpos = 0
        if use_native:
            cnt, maxlen = native.scan(chunk)
            if cnt == 0:
                continue
            L = max((maxlen + pad_quantum - 1) // pad_quantum * pad_quantum, pad_quantum)
            for c, q, l, n in native.parse_blocks(chunk, block_reads, L, qual_pad=qual_offset):
                h = None
                if with_ids:
                    h = (hdrs[0][hpos : hpos + n], hdrs[1][hpos : hpos + n])
                    hpos += n
                rb.add(c[:n], q[:n], l[:n], h)
        else:
            ids, seqs, quals = parse_fastq_bytes(chunk)
            if not seqs:
                continue
            from ..models.assembler import _lists_to_block

            c, q, l = _lists_to_block(seqs, quals, pad_quantum, qual_offset)
            rb.add(c, q, l, hdrs)
        yield from rb.full_blocks()
    yield from rb.flush()


def _scan_records(fname: str, start: int, chunk_bytes: int = 1 << 16):
    """Yield (file_offset, header_line_bytes) for records at/after `start`,
    resyncing to the first record boundary (reference get_next_fq_record scan
    role inside set_matching_pair, fastq.cpp:310-396)."""
    import os

    size = os.path.getsize(fname)
    if start >= size:
        return
    with open(fname, "rb") as f:
        f.seek(start)
        buf = b""
        base = start
        synced = start == 0
        eof = False
        while True:
            if not eof:
                data = f.read(chunk_bytes)
                eof = not data
                buf += data
            if not synced:
                p = _resync_offset(b"x" + buf, 1) - 1
                if p >= len(buf):
                    if eof:
                        return
                    continue
                base += p
                buf = buf[p:]
                synced = True
            # emit complete 4-line records currently in the buffer
            pos = 0
            while True:
                e0 = buf.find(b"\n", pos)
                if e0 < 0:
                    break
                e = e0
                complete = True
                for _ in range(3):
                    e = buf.find(b"\n", e + 1)
                    if e < 0:
                        complete = False
                        break
                if not complete:
                    break
                yield base + pos, buf[pos:e0]
                pos = e + 1
            base += pos
            buf = buf[pos:]
            if eof:
                return


def matching_pair_starts(f1: str, f2: str, off1: int, off2: int):
    """Pair-aligned start offsets at/after the naive (off1, off2) byte
    offsets — the reference's set_matching_pair scan (fastq.cpp:310-396).

    Alternately reads one record from each file, remembering each file's
    first record name; stops as soon as one stream reaches the other's first
    name, which identifies the common pair boundary. Returns (start1, start2)
    or (size1, size2) when no overlap exists in the remainder (tiny file,
    many ranks)."""
    import os

    if off1 == 0 and off2 == 0:
        return 0, 0
    sizes = os.path.getsize(f1), os.path.getsize(f2)

    def base_name(header):
        norm = normalize_fq_name(header)
        if norm is None:
            raise ValueError(f"unrecognizable FASTQ header for pairing: {header!r}")
        return norm[0]

    it1, it2 = _scan_records(f1, off1), _scan_records(f2, off2)
    first1 = first2 = None
    pos1_first = pos2_first = None
    while True:
        r1 = next(it1, None)
        if r1 is None:
            return sizes
        pos1, h1 = r1
        n1 = base_name(h1)
        if pos1_first is None:
            pos1_first, first1 = pos1, n1
        if first2 is not None and n1 == first2:
            return pos1, pos2_first
        r2 = next(it2, None)
        if r2 is None:
            return sizes
        pos2, h2 = r2
        n2 = base_name(h2)
        if pos2_first is None:
            pos2_first, first2 = pos2, n2
        if n2 == first1:
            return pos1_first, pos2


def matching_pair_ranges(f1: str, f2: str, rank: int, n_ranks: int):
    """Per-rank byte ranges of a two-file pair aligned to a common PAIR
    boundary (reference fastq.cpp:310-396): record ordinals inside the
    ranges correspond, even when the two files have different record byte
    sizes. Deterministic per boundary, so each rank computes its own start
    and its successor's start (= its stop) independently — the bulk-
    synchronous replacement for the reference's rank-to-rank rpc handoff."""
    import os

    sizes = os.path.getsize(f1), os.path.getsize(f2)

    def start(r):
        if r <= 0:
            return 0, 0
        if r >= n_ranks:
            return sizes
        return matching_pair_starts(f1, f2, sizes[0] * r // n_ranks, sizes[1] * r // n_ranks)

    lo1, lo2 = start(rank)
    hi1, hi2 = start(rank + 1)
    return (lo1, max(hi1, lo1)), (lo2, max(hi2, lo2))
