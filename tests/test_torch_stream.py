"""The port's streaming ingest (mhm2_proxy_tpu_torch/io/stream.py) against
the JAX reference's stream_fastq_blocks on the same files, on the CPU.

Every block must hold the reference's rows: the same n and row count, and
within each read the same length, bases and qualities, within each header
the same bytes and length. The port's widths may differ (a multiple of
pad_quantum at least the block's longest read); its padding must be 4 for
codes, qual_offset for qualities and 0 for headers, in every cell no read
covers. Each case runs the one-pass native parse and, with the native
parser hidden, the pure-Python fallback.
"""

import gzip
import shutil

import numpy as np
import pytest

from mhm2_proxy_tpu.io.stream import stream_fastq_blocks as ref_stream_fastq_blocks
from mhm2_proxy_tpu_torch.io import native
from mhm2_proxy_tpu_torch.io.stream import stream_fastq_blocks
from mhm2_proxy_tpu_torch.models.assembler import _parsed_blocks
from mhm2_proxy_tpu_torch.utils import trace

QUANTUM = 32
QOFF = 33

needs_cxx = pytest.mark.skipif(shutil.which("c++") is None and shutil.which("g++") is None,
                               reason="no C++ compiler for the native parser")


def _records(rng, n, lens, alphabet=b"ACGT", prefix=b"r"):
    """n FASTQ records (bytes each) with read lengths `lens`."""
    alpha = np.frombuffer(alphabet, np.uint8)
    out = []
    for i in range(n):
        L = int(lens[i])
        seq = alpha[rng.integers(0, len(alpha), L)].tobytes()
        qual = (rng.integers(2, 41, L) + QOFF).astype(np.uint8).tobytes()
        out.append(b"@" + prefix + str(i).encode() + b"/" + str(1 + i % 2).encode()
                   + b" extra:" + b"x" * int(rng.integers(0, 12)) + b"\n"
                   + seq + b"\n+\n" + qual + b"\n")
    return out


def _file(kind, rng, tmp_path):
    """(path, text) of one case's FASTQ."""
    if kind == "empty":
        text = b""
    elif kind == "uniform":
        text = b"".join(_records(rng, 1001, np.full(1001, 150)))
    elif kind == "mixed":
        # lengths 1-300 over every code path of the base conversion (under,
        # at and past 32 and 64 bases), lower case, N and other letters; the
        # longest reads come late, so a later chunk widens a block
        n = 700
        lens = np.sort(rng.integers(1, 301, n))
        lens[rng.integers(0, n // 3, 40)] = rng.integers(1, 80, 40)
        lens[:7] = [31, 32, 33, 63, 64, 65, 0]
        text = b"".join(_records(rng, n, lens, alphabet=b"ACGTacgtNnRYKM.-*"))
    elif kind == "no_newline":
        text = b"".join(_records(rng, 333, rng.integers(90, 160, 333)))[:-1]
    else:
        raise ValueError(kind)
    path = str(tmp_path / "reads.fastq")
    with open(path, "wb") as f:
        f.write(text)
    return path, text


# (id, file, chunk_bytes, block_reads, with_ids, ranks, gzip)
CASES = [
    ("uniform_4k_ids", "uniform", 4096, 64, True, 1, False),
    ("uniform_8m", "uniform", 8 << 20, 300, False, 1, False),
    ("uniform_8m_ids", "uniform", 8 << 20, 1000, True, 1, False),
    ("below_record_ids", "uniform", 50, 7, True, 1, False),
    ("below_record", "mixed", 100, 13, False, 1, False),
    ("ranks2_ids", "uniform", 4096, 64, True, 2, False),
    ("ranks3", "mixed", 4096, 50, False, 3, False),
    ("ranks4_ids", "mixed", 1000, 41, True, 4, False),
    ("gzip_ids", "uniform", 4096, 64, True, 1, True),
    ("gzip", "mixed", 8 << 20, 128, False, 1, True),
    ("mixed_4k_ids", "mixed", 4096, 50, True, 1, False),
    ("mixed_8m_ids", "mixed", 8 << 20, 256, True, 1, False),
    ("no_newline_ids", "no_newline", 4096, 100, True, 1, False),
    ("no_newline_below_record", "no_newline", 64, 9, False, 1, False),
    ("empty_ids", "empty", 4096, 64, True, 1, False),
    ("empty", "empty", 8 << 20, 64, False, 1, False),
]


def _check_block(got, ref, with_ids):
    c, q, l, n = got[:4]
    rc, rq, rl, rn = ref[:4]
    assert n == rn and c.shape[0] == rc.shape[0] == q.shape[0] == l.shape[0]
    assert c.shape == q.shape and c.shape[1] % QUANTUM == 0
    assert c.shape[1] >= int(l.max(initial=0))
    np.testing.assert_array_equal(l[:n], rl[:n])
    assert not l[n:].any()
    cols = np.arange(c.shape[1])
    inside = cols < l[:, None]
    rcols = np.arange(rc.shape[1]) < rl[:, None]
    np.testing.assert_array_equal(c[inside], rc[rcols])
    np.testing.assert_array_equal(q[inside], rq[rcols])
    assert (c[~inside] == 4).all() and (q[~inside] == QOFF).all()
    if with_ids:
        (hm, hl), (rhm, rhl) = got[4], ref[4]
        assert hm.shape[0] == c.shape[0]
        np.testing.assert_array_equal(hl[:n], rhl[:n])
        assert not hl[n:].any()
        hin = np.arange(hm.shape[1]) < hl[:, None]
        np.testing.assert_array_equal(hm[hin], rhm[np.arange(rhm.shape[1]) < rhl[:, None]])
        assert not hm[~hin].any()


@pytest.mark.parametrize("path", [pytest.param("one_pass", marks=needs_cxx), "python"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_blocks_equal_reference(case, path, tmp_path, monkeypatch):
    _, kind, chunk, B, with_ids, ranks, gz = case
    rng = np.random.default_rng(CASES.index(case))
    fname, text = _file(kind, rng, tmp_path)
    if gz:
        fname += ".gz"
        with gzip.open(fname, "wb") as f:
            f.write(text)
    if path == "python":
        monkeypatch.setattr(native, "parse_into_available", lambda: False)
    else:
        assert native.parse_into_available(), "the native parser did not build"
    size = len(text)
    kw = dict(pad_quantum=QUANTUM, qual_offset=QOFF, chunk_bytes=chunk)
    n_reads = 0
    for r in range(ranks):
        br = (size * r // ranks, size * (r + 1) // ranks) if ranks > 1 else None
        ref = list(ref_stream_fastq_blocks(fname, B, byte_range=br, with_ids=with_ids, **kw))
        with trace.recording(syncs=False) as spans:
            got = list(_parsed_blocks(fname, B, br, with_ids, kw))
        assert len(got) == len(ref)
        for g, rf in zip(got, ref):
            _check_block(g, rf, with_ids)
        n_reads += sum(b[3] for b in got)
        row = trace.summary(spans).get("ingest.parse", {})
        assert row.get("reads", 0) == sum(b[3] for b in ref)
        # each block is counted once; the one-pass parse also counts the
        # rows it copies when a longer read or header widens a block
        blocks = sum(sum(a.nbytes for a in b[:3]) + (b[4][0].nbytes + b[4][1].nbytes
                                                     if with_ids else 0) for b in got)
        if path == "one_pass":
            assert row.get("out_bytes", 0) >= blocks
        else:
            assert row.get("out_bytes", 0) == blocks
    assert n_reads == (text.count(b"\n") + (not text.endswith(b"\n") and len(text) > 0)) // 4


@needs_cxx
def test_ranks_count_every_byte_once(tmp_path):
    """Over a partition of the file into ranks, the ranks' `bytes` add up
    to the file and each equals its range to within one record."""
    rng = np.random.default_rng(5)
    fname, text = _file("uniform", rng, tmp_path)
    kw = dict(pad_quantum=QUANTUM, qual_offset=QOFF, chunk_bytes=4096)
    total = 0
    for r in range(4):
        br = (len(text) * r // 4, len(text) * (r + 1) // 4)
        with trace.recording(syncs=False) as spans:
            for _ in _parsed_blocks(fname, 64, br, True, kw):
                pass
        row = trace.summary(spans)["ingest.parse"]
        assert abs(row["bytes"] - (br[1] - br[0])) < 400
        total += row["bytes"]
    assert total == len(text)


def _block(B, L, HW, fill=0xEE):
    return (np.full((B, L), fill, np.uint8), np.full((B, L), fill, np.uint8),
            np.full(B, -7, np.int32), np.full((B, HW), fill, np.uint8), np.full(B, -7, np.int32))


@needs_cxx
@pytest.mark.parametrize("final", [False, True])
def test_parse_into_rows_and_cut(final):
    """fastq_parse_into writes only the rows of the records it parsed, from
    row0 on, each whole; a record cut by the buffer's end is not consumed in
    a buffer that is not final, and the offset lands on its first byte."""
    recs = [b"@a1\nACGTN\n+\nIIIII\n", b"@b22 x\n" + b"acgt" * 10 + b"\n+\n" + b"J" * 40 + b"\n",
            b"@c\n\n+\n\n", b"@d4\nGGA\n+\nHH\n"]
    cut = b"@e5\nTTTT\n+\nII"
    text = b"".join(recs) + cut
    arr = np.frombuffer(text, np.uint8)
    codes, quals, lens, hdrs, hlens = _block(10, 64, 16)
    got, off, longest, need, hneed = native.parse_into(arr, 0, final, 3, codes, quals, lens,
                                                       QOFF, hdrs, hlens)
    n = len(recs) + (1 if final else 0)
    assert got == n and longest == 40 and need == 0 and hneed == 0
    assert off == (len(text) if final else len(text) - len(cut))
    untouched = np.r_[0:3, 3 + n:10]
    assert (codes[untouched] == 0xEE).all() and (quals[untouched] == 0xEE).all()
    assert (lens[untouched] == -7).all() and (hlens[untouched] == -7).all()
    assert (hdrs[untouched] == 0xEE).all()
    lut = {ord(ch): v for ch, v in zip("ACGTacgt", [0, 1, 2, 3] * 2)}
    for i, rec in enumerate(recs + ([cut] if final else [])):
        h, s, _, qq = (rec.split(b"\n") + [b""])[:4]
        row = 3 + i
        assert lens[row] == len(s) and hlens[row] == len(h)
        assert codes[row, : len(s)].tolist() == [lut.get(b, 4) for b in s]
        assert (codes[row, len(s):] == 4).all()
        ql = min(len(qq), len(s))
        assert quals[row, :ql].tobytes() == qq[:ql] and (quals[row, ql:] == QOFF).all()
        assert hdrs[row, : len(h)].tobytes() == h and not hdrs[row, len(h):].any()

    # the block's end: three rows left take three records, and the offset
    # is the fourth's start
    codes, quals, lens, hdrs, hlens = _block(10, 64, 16)
    got, off, *_ = native.parse_into(arr, 0, final, 7, codes, quals, lens, QOFF, hdrs, hlens)
    assert got == 3 and off == sum(map(len, recs[:3]))
    assert (codes[:7] == 0xEE).all() and (lens[:7] == -7).all()

    # a read longer than the width, then a header longer than its matrix:
    # each stops the parse before its record and names the length it needs
    codes, quals, lens, hdrs, hlens = _block(10, 32, 16)
    got, off, longest, need, hneed = native.parse_into(arr, 0, final, 0, codes, quals, lens,
                                                       QOFF, hdrs, hlens)
    assert (got, off, longest, need, hneed) == (1, len(recs[0]), 5, 40, 0)
    assert (codes[1:] == 0xEE).all()
    codes, quals, lens, hdrs, hlens = _block(10, 64, 4)
    got, off, longest, need, hneed = native.parse_into(arr, 0, final, 0, codes, quals, lens,
                                                       QOFF, hdrs, hlens)
    assert (got, off, need, hneed) == (1, len(recs[0]), 0, 6)
    # without headers, only the read's width stops it
    codes, quals, lens = _block(10, 64, 4)[:3]
    got, off, *_ = native.parse_into(arr, 0, final, 0, codes, quals, lens, QOFF)
    assert got == n and off == (len(text) if final else len(text) - len(cut))


def test_parse_into_rejects_bad_blocks():
    """Arrays of another type, shape or layout, or a row past the block,
    raise before any pointer reaches the native parser."""
    arr = np.frombuffer(b"@a\nAC\n+\nII\n", np.uint8)
    codes, quals, lens, hdrs, hlens = _block(4, 32, 8)
    bad = [dict(quals=np.empty((4, 64), np.uint8)[:, ::2]), dict(lens=lens.astype(np.int64)),
           dict(codes=codes[:2]), dict(row0=5), dict(hdrs=hdrs[:3]),
           dict(buf=arr.astype(np.int16))]
    for change in bad:
        kw = dict(buf=arr, codes=codes, quals=quals, lens=lens, hdrs=hdrs, hdr_lens=hlens, row0=0)
        kw.update(change)
        with pytest.raises(ValueError):
            native.parse_into(kw["buf"], 0, True, kw["row0"], kw["codes"], kw["quals"], kw["lens"],
                              QOFF, kw["hdrs"], kw["hdr_lens"])
    assert (codes == 0xEE).all() and (lens == -7).all()
