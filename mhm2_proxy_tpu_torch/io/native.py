"""ctypes bindings for the host's native code: the pair merge and the
stitcher of the shared library (native/, built on demand with make), and
the port's own one-pass FASTQ parser (csrc/fastq_into.cpp).

The parser is built by the C++ compiler into
`mhm2_proxy_tpu_torch/_build/<hash>/libmhm2_fastq.so`, keyed by a hash of
its source and flags, at its first use in a process; the library is linked
under a temporary name and renamed into place, so a process never loads a
half-written one. Without a compiler the ingest falls back to the
pure-Python reader (the reference's CPU/GPU-style backend seam applied to
ingest).

    c++ -O3 -march=native -fPIC -std=c++17 -Wall -shared \
        -o libmhm2_fastq.so csrc/fastq_into.cpp
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libmhm2_native.so"))
_PKG = Path(__file__).resolve().parent.parent
_PARSE_SRC = _PKG / "csrc" / "fastq_into.cpp"
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib = None
_parse_lib = None  # the parser's library; False once it could not be built or loaded


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(
                ["make", "-s"], cwd=os.path.abspath(_NATIVE_DIR), check=True,
                capture_output=True,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        return None
    try:
        lib.mhm2_merge_pairs.restype = ctypes.c_int64
        lib.mhm2_merge_pairs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
    except AttributeError:
        # stale .so predating the merge engine; rebuild lazily next run
        lib._has_merge = False
    else:
        lib._has_merge = True
    try:
        lib.stitch_walk.restype = ctypes.c_int64
        lib.stitch_walk.argtypes = [
            ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
    except AttributeError:
        lib._has_stitch = False
    else:
        lib._has_stitch = True
    _lib = lib
    return lib


def get_stitch_walk():
    """Callable wrapping the native sequential stitcher, or None.

    Signature: walk(succ (S,) i64, base (S,) u8, counts (n,) i32, k,
    out_buf u8, out_start i64, out_nstates i64, out_depth i64) -> n_paths.
    """
    lib = _load()
    if lib is None or not getattr(lib, "_has_stitch", False):
        return None

    def walk(succ, base, counts, k, buf, starts, nst, dep):
        return lib.stitch_walk(
            succ.shape[0], int(k),
            succ.ctypes.data_as(ctypes.c_void_p),
            base.ctypes.data_as(ctypes.c_void_p),
            counts.ctypes.data_as(ctypes.c_void_p),
            buf.ctypes.data_as(ctypes.c_void_p), buf.shape[0],
            starts.ctypes.data_as(ctypes.c_void_p),
            nst.ctypes.data_as(ctypes.c_void_p),
            dep.ctypes.data_as(ctypes.c_void_p),
            starts.shape[0],
        )

    return walk


def _build_parse():
    """Build (if its hash is new) and load the parser's library, or None."""
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode() + _PARSE_SRC.read_bytes()).hexdigest()[:16]
    so = _PKG / "_build" / h / "libmhm2_fastq.so"
    if not so.exists():
        cxx = shutil.which("c++") or shutil.which("g++")
        if cxx is None:
            return None
        tmp = so.with_name(f"libmhm2_fastq.{os.getpid()}.tmp.so")
        try:
            so.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run([cxx, *_CXXFLAGS, "-o", str(tmp), str(_PARSE_SRC)],
                           check=True, capture_output=True)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.fastq_parse_into.restype = ctypes.c_int64
    lib.fastq_parse_into.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint8,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib


def parse_into_available() -> bool:
    global _parse_lib
    if _parse_lib is None:
        _parse_lib = _build_parse() or False
    return _parse_lib is not False


def parse_into(buf: np.ndarray, offset: int, final: bool, row0: int, codes, quals, lens,
               qual_pad: int = 33, hdrs=None, hdr_lens=None):
    """Parse the records of buf[offset:] (u8) straight into rows row0.. of a
    block (csrc/fastq_into.cpp::fastq_parse_into): codes / quals (B, L) u8,
    lens (B,) i32, and with hdrs the header lines into hdrs (B, W) u8 and
    hdr_lens (B,) i32. `final` marks the file's last bytes, whose last line
    may lack its newline.

    Returns (records written, the offset after them, the longest read
    written, the read length and the header length of a record too long
    for the block's widths, 0 where none).
    """
    B, L = codes.shape
    u8 = (buf, codes, quals) + (() if hdrs is None else (hdrs,))
    i32 = (lens,) + (() if hdrs is None else (hdr_lens,))
    if not (all(a.flags.c_contiguous for a in u8 + i32) and all(a.dtype == np.uint8 for a in u8)
            and all(a.dtype == np.int32 and a.shape == (B,) for a in i32)
            and quals.shape == (B, L) and (hdrs is None or hdrs.shape[0] == B)
            and 0 <= row0 <= B and 0 <= offset <= buf.size):
        raise ValueError("parse_into: a block array of another type, shape or layout")
    if not parse_into_available():
        raise RuntimeError("parse_into: the parser's library could not be built")
    out = np.zeros(4, np.int64)
    p = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    got = _parse_lib.fastq_parse_into(
        p(buf), buf.size, offset, int(final), row0, B, L, qual_pad,
        p(codes), p(quals), p(lens),
        0 if hdrs is None else hdrs.shape[1], p(hdrs), p(hdr_lens), p(out),
    )
    return int(got), int(out[0]), int(out[1]), int(out[2]), int(out[3])


def merge_available() -> bool:
    lib = _load()
    return lib is not None and getattr(lib, "_has_merge", False)


def merge_pairs(codes1, quals1, len1, codes2, quals2, len2, qual_offset=33,
                n_threads: int | None = None):
    """Native paired-read merge (native/merge_native.cpp).

    Same result dict contract as io.merge.merge_pairs_block (numpy arrays):
    merged, m_codes, m_quals, m_len, overlap, quals1_z, quals2_z,
    n_ambiguous.
    """
    lib = _load()
    c1 = np.ascontiguousarray(codes1, np.uint8)
    c2 = np.ascontiguousarray(codes2, np.uint8)
    q1 = np.ascontiguousarray(quals1, np.uint8)
    q2 = np.ascontiguousarray(quals2, np.uint8)
    l1 = np.ascontiguousarray(len1, np.int32)
    l2 = np.ascontiguousarray(len2, np.int32)
    B, L = c1.shape
    if n_threads is None:
        n_threads = max(1, (os.cpu_count() or 2))
    merged = np.empty((B,), np.uint8)
    m_codes = np.empty((B, 2 * L), np.uint8)
    m_quals = np.empty((B, 2 * L), np.uint8)
    m_len = np.empty((B,), np.int32)
    overlap = np.empty((B,), np.int32)
    q1z = np.empty((B, L), np.uint8)
    q2z = np.empty((B, L), np.uint8)
    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
    n_ambig = lib.mhm2_merge_pairs(
        p(c1), p(q1), p(l1), p(c2), p(q2), p(l2),
        B, L, qual_offset, n_threads,
        p(merged), p(m_codes), p(m_quals), p(m_len), p(overlap), p(q1z), p(q2z),
    )
    return dict(
        merged=merged.astype(bool), m_codes=m_codes, m_quals=m_quals,
        m_len=m_len, overlap=overlap, quals1_z=q1z, quals2_z=q2z,
        n_ambiguous=int(n_ambig),
    )
