"""FASTQ ingest: vectorized parsing with byte-range partitioning.

Replaces the reference's FastqReader (src/fastq.cpp): the whole file (or a
rank's byte range) is loaded and parsed with numpy newline indexing instead of
per-record getline loops. Record-boundary resync for mid-file byte ranges
mirrors the reference's state machine (fastq.cpp:124-238): scan forward for an
'@' header line whose +2 line is '+', validating the 4-line phase.

Supports plain and gzip files, paired two-file inputs ("f1:f2" naming like
options.cpp:315-335) and interleaved single files.
"""

from __future__ import annotations

import gzip
import io

import numpy as np


def _open(fname: str):
    if fname.endswith(".gz"):
        return gzip.open(fname, "rb")
    return open(fname, "rb")


def _resync_offset(buf: bytes, start: int) -> int:
    """First record boundary at/after start (reference fastq.cpp:124-238).

    A boundary is a line starting with '@' such that the line two lines later
    starts with '+' (quality headers can also start with '@', so a lone '@' is
    not sufficient).
    """
    if start == 0:
        return 0
    pos = buf.find(b"\n", start)
    if pos < 0:
        return len(buf)
    pos += 1
    # try up to 4 line offsets to find the header phase
    cand = pos
    for _ in range(8):
        if cand >= len(buf):
            return len(buf)
        if buf[cand : cand + 1] == b"@":
            # check that line cand+2 starts with '+'
            e1 = buf.find(b"\n", cand)
            if e1 < 0:
                return len(buf)
            e2 = buf.find(b"\n", e1 + 1)
            if e2 < 0:
                return len(buf)
            if buf[e2 + 1 : e2 + 2] == b"+":
                return cand
        nxt = buf.find(b"\n", cand)
        if nxt < 0:
            return len(buf)
        cand = nxt + 1
    return cand


def parse_fastq_bytes(buf: bytes):
    """Parse FASTQ bytes -> (ids list[bytes], seqs list[bytes], quals list[bytes]).

    Vectorized: newline positions via numpy, then slicing.
    """
    arr = np.frombuffer(buf, np.uint8)
    nl = np.nonzero(arr == ord("\n"))[0]
    if len(buf) and not buf.endswith(b"\n"):
        nl = np.append(nl, len(buf))
    n_lines = len(nl)
    n_rec = n_lines // 4
    starts = np.concatenate([[0], nl[:-1] + 1])[: n_rec * 4]
    ends = nl[: n_rec * 4]
    ids, seqs, quals = [], [], []
    for r in range(n_rec):
        ids.append(buf[starts[4 * r] : ends[4 * r]])
        seqs.append(buf[starts[4 * r + 1] : ends[4 * r + 1]])
        quals.append(buf[starts[4 * r + 3] : ends[4 * r + 3]])
    return ids, seqs, quals


class FastqReader:
    """Reads a byte range of a FASTQ file with boundary resync.

    rank/n_ranks partition the file by bytes like the reference
    (fastq.cpp:263-276, 399-455); each rank parses [resync(lo), resync(hi)).
    """

    def __init__(self, fname: str, rank: int = 0, n_ranks: int = 1):
        self.fname = fname
        with _open(fname) as f:
            data = f.read()
        size = len(data)
        lo = size * rank // n_ranks
        hi = size * (rank + 1) // n_ranks
        lo = _resync_offset(data, lo)
        hi = _resync_offset(data, hi) if hi < size else size
        self.ids, self.seqs, self.quals = parse_fastq_bytes(data[lo:hi])

    def __len__(self):
        return len(self.seqs)


def read_fastq(fname: str, rank: int = 0, n_ranks: int = 1):
    r = FastqReader(fname, rank, n_ranks)
    return r.ids, r.seqs, r.quals


def write_fastq(fname: str, ids, seqs, quals):
    out = io.BytesIO()
    for i, s, q in zip(ids, seqs, quals):
        i = i if isinstance(i, bytes) else i.encode()
        s = s if isinstance(s, bytes) else s.encode()
        q = q if isinstance(q, bytes) else q.encode()
        out.write(b"@" + i.lstrip(b"@") + b"\n" + s + b"\n+\n" + q + b"\n")
    opener = gzip.open if fname.endswith(".gz") else open
    with opener(fname, "wb") as f:
        f.write(out.getvalue())


def normalize_fq_name(header: bytes):
    """Normalize a FASTQ header to (base_name, pair_num) — reference
    get_fq_name parity (fastq.cpp:73-122).

    Handles: classic `@name/1`, HudsonAlpha `@name-R1` (any separator char
    before R), and new-Illumina `@name 1:N:0:...` (pair in the first comment
    char, colon structure validated). pair_num is 1/2, or 0 when the name
    carries no pair designator. Returns None for an unrecognizable header
    (missing '@' or malformed new-Illumina comment) — callers treat that as
    a hard input error like the reference's SWARN/DIE path.
    """
    if not header.startswith(b"@"):
        return None
    h = header[1:].rstrip()
    n = len(h)
    if n >= 3 and h[-2:-1] == b"/" and h[-1:] in b"12":
        return h[:-2], int(h[-1:])
    if n >= 3 and h[-2:-1] == b"R" and h[-1:] in b"12":
        # HudsonAlpha @pair-R1 -> base excludes the 3 trailing chars
        return h[:-3], int(h[-1:])
    end = h.find(b"\t")
    if end < 0:
        end = h.find(b" ")
        if end < 0:
            return h, 0
    if end > 3 and h[end - 2 : end - 1] == b"/" and h[end - 1 : end] in b"12":
        return h[: end - 2], int(h[end - 1 : end])
    if (
        n < end + 7
        or h[end + 2 : end + 3] != b":"
        or h[end + 4 : end + 5] != b":"
        or h[end + 6 : end + 7] != b":"
        or h[end + 1 : end + 2] not in b"12"
    ):
        return None
    return h[:end], int(h[end + 1 : end + 2])


def headers_from_chunk(buf: bytes):
    """All header lines of a record-complete chunk as a padded byte matrix.

    Returns (mat (n, W) uint8 zero-padded, lens (n,) int32). Vectorized: no
    per-record Python. The chunk must start at a record boundary (guaranteed
    by FastqStream cutting).
    """
    arr = np.frombuffer(buf, np.uint8)
    nl = np.nonzero(arr == ord("\n"))[0]
    if len(buf) and not buf.endswith(b"\n"):
        nl = np.append(nl, len(buf))
    nrec = len(nl) // 4
    if nrec == 0:
        return np.zeros((0, 1), np.uint8), np.zeros((0,), np.int32)
    starts = np.concatenate([[0], nl[:-1] + 1])
    hs = starts[0::4][:nrec]
    he = nl[0::4][:nrec]
    lens = (he - hs).astype(np.int32)
    W = max(int(lens.max()), 1)
    idx = hs[:, None] + np.arange(W)
    mat = arr[np.minimum(idx, len(arr) - 1)] * (np.arange(W) < lens[:, None])
    return mat.astype(np.uint8), lens


def check_pair_block(m1, l1, m2, l2) -> int:
    """Validate that record i of file1 and file2 are mates, for a whole block
    at once (vectorized analog of the reference's per-pair name check,
    merge_reads.cpp:346-348 + fastq.cpp get_fq_name).

    m/l are headers_from_chunk outputs. Mates must have equal base names and
    pair designators (1,2) — or identical designator-free names (some archives
    keep mate names byte-identical). Returns the first offending row index,
    or -1 when every row pairs up.
    """
    n = m1.shape[0]
    if n != m2.shape[0]:
        return min(n, m2.shape[0])
    if n == 0:
        return -1

    def fields(m, l):
        # name token: after '@', up to first space/tab (still zero-padded)
        W = m.shape[1]
        cols = np.arange(W)
        ws = ((m == 32) | (m == 9)) & (cols < l[:, None])
        t = np.where(ws.any(1), ws.argmax(1), l)  # token end (excl)
        r = np.arange(len(l))
        cm2 = m[r, np.maximum(t - 2, 0)]  # char before last token char
        cm1 = m[r, np.maximum(t - 1, 0)]  # last token char
        old = (t >= 3) & (cm2 == ord("/")) & ((cm1 == ord("1")) | (cm1 == ord("2")))
        hud = (t >= 3) & (cm2 == ord("R")) & ((cm1 == ord("1")) | (cm1 == ord("2")))
        # new-Illumina: pair char just after the whitespace, then ':'
        has_c = t < l
        cc1 = m[r, np.minimum(t + 1, W - 1)]
        cc2 = m[r, np.minimum(t + 2, W - 1)]
        new = has_c & ~old & ~hud & ((cc1 == ord("1")) | (cc1 == ord("2"))) & (cc2 == ord(":"))
        pair = np.where(old | hud, cm1 - ord("0"), np.where(new, cc1 - ord("0"), 0))
        base_end = np.where(old, t - 2, np.where(hud, t - 3, t))
        return pair.astype(np.int32), base_end.astype(np.int32), t

    p1, b1, _ = fields(m1, l1)
    p2, b2, _ = fields(m2, l2)
    W = max(m1.shape[1], m2.shape[1])
    pad = lambda m: m if m.shape[1] == W else np.pad(m, ((0, 0), (0, W - m.shape[1])))
    m1p, m2p = pad(m1), pad(m2)
    cols = np.arange(W)
    # compare base-name bytes (positions 1..base_end; col 0 is '@')
    in1 = (cols >= 1) & (cols < b1[:, None])
    in2 = (cols >= 1) & (cols < b2[:, None])
    names_eq = (b1 == b2) & ((m1p * in1) == (m2p * in2)).all(1)
    ok = names_eq & (((p1 == 1) & (p2 == 2)) | ((p1 == 0) & (p2 == 0)))
    if ok.all():
        return -1
    return int(np.argmin(ok))


_CODE_LUT = np.frombuffer(b"ACGTN", np.uint8)


def render_fastq_block(ids64, codes, quals, lens) -> bytes:
    """Render a packed block to FASTQ bytes with zero per-read Python.

    Names follow the reference convention r<id>/<mate> (merge_reads.cpp:
    306-312: magnitude shared by mates, mate from the id sign); anonymous
    rows (id 0) fall back to r<row>/1. Everything — decimal id digits,
    ragged sequence/quality scatter — is vectorized numpy, so arctic-scale
    --checkpoint-merged renders in seconds, not minutes.
    """
    lens = np.asarray(lens, np.int64)
    keep = lens > 0
    if not keep.any():
        return b""
    ids64 = np.asarray(ids64, np.int64)[keep]
    codes, quals, lens = codes[keep], quals[keep], lens[keep]
    n = len(lens)
    mate = np.where(ids64 > 0, ord("2"), ord("1")).astype(np.uint8)
    absid = np.where(ids64 == 0, np.arange(n), np.abs(ids64)).astype(np.uint64)
    # decimal digits, leading zeros masked off (digit count by integer
    # threshold compare — float log10 mis-rounds near powers of 10)
    thresholds = (10 ** np.arange(1, 20, dtype=np.uint64))
    ndig = 1 + (absid[:, None] >= thresholds[None, :]).sum(1).astype(np.int64)
    D = int(ndig.max())
    pow10 = (10 ** np.arange(D - 1, -1, -1)).astype(np.uint64)
    digits = (absid[:, None] // pow10) % 10
    # name layout: '@' 'r' [D digits] '/' mate '\n' -> width D+5, right-packed
    name_w = ndig + 5
    # per-record segment lengths: name + seq\n + '+\n' + qual\n
    seg = name_w + lens + 1 + 2 + lens + 1
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(seg, out=starts[1:])
    out = np.empty(int(starts[-1]), np.uint8)

    def ragged_targets(seg_starts, seg_lens):
        total = int(seg_lens.sum())
        reps = np.repeat(seg_starts, seg_lens)
        intra = np.arange(total) - np.repeat(
            np.concatenate([[0], np.cumsum(seg_lens)[:-1]]), seg_lens
        )
        return reps + intra

    # names: fixed head '@r', digits (skip leading zeros), '/',mate,'\n'
    rs = starts[:-1]
    out[rs] = ord("@")
    out[rs + 1] = ord("r")
    dig_t = ragged_targets(rs + 2, ndig)
    dig_keep = (np.arange(D) >= (D - ndig)[:, None])
    out[dig_t] = (digits + ord("0")).astype(np.uint8)[dig_keep]
    out[rs + 2 + ndig] = ord("/")
    out[rs + 3 + ndig] = mate
    out[rs + 4 + ndig] = ord("\n")
    # sequence + quality rows
    col_keep = np.arange(codes.shape[1]) < lens[:, None]
    seq_t = ragged_targets(rs + name_w, lens)
    out[seq_t] = _CODE_LUT[np.minimum(codes, 4)][col_keep]
    out[rs + name_w + lens] = ord("\n")
    out[rs + name_w + lens + 1] = ord("+")
    out[rs + name_w + lens + 2] = ord("\n")
    qual_t = ragged_targets(rs + name_w + lens + 3, lens)
    out[qual_t] = quals[col_keep]
    out[starts[1:] - 1] = ord("\n")
    return out.tobytes()


def parse_rid_headers(mat, lens):
    """Parse `@r<digits>/<mate>` headers back to signed int64 read ids
    (vectorized inverse of render_fastq_block naming). Rows that don't match
    the convention get id 0 (anonymous)."""
    n, W = mat.shape
    if n == 0:
        return np.zeros((0,), np.int64)
    cols = np.arange(W)
    valid_col = cols < np.asarray(lens)[:, None]
    isdig = (mat >= ord("0")) & (mat <= ord("9")) & valid_col
    run = np.cumprod(isdig[:, 2:], axis=1) if W > 2 else np.zeros((n, 0), np.int64)
    ndig = run.sum(1).astype(np.int64)
    digits = (mat[:, 2:].astype(np.int64) - ord("0")) * run
    # place value: digit at offset j (0-based) weighs 10^(ndig-1-j), exact
    # int64 powers (exponent clipped; ids needing >18 digits are rejected)
    j = np.arange(W - 2)
    expo = np.clip(ndig[:, None] - 1 - j, 0, 18).astype(np.int64)
    weight = np.where(run > 0, 10 ** expo, 0)
    value = (digits * weight).sum(1)
    r = np.arange(n)
    slash = mat[r, np.minimum(2 + ndig, W - 1)]
    mate = mat[r, np.minimum(3 + ndig, W - 1)]
    ok = (
        (mat[:, 0] == ord("@")) & (mat[:, 1] == ord("r")) & (ndig > 0)
        & (slash == ord("/")) & ((mate == ord("1")) | (mate == ord("2")))
        & (ndig <= 18)  # int64 place-value bound
    )
    signed = np.where(mate == ord("1"), -value, value)
    return np.where(ok, signed, 0).astype(np.int64)


def split_paired_fname(reads_fname: str):
    """'f1:f2' paired naming (reference options.cpp:315-335) -> (f1, f2|None)."""
    if ":" in reads_fname:
        a, b = reads_fname.split(":", 1)
        return a, b
    return reads_fname, None
