"""ctypes bindings for the port's host library: the port's one-pass FASTQ
parser (csrc/fastq_into.cpp), and the pair merge and the stitcher of the
JAX package's native sources (native/merge_native.cpp,
native/stitch_native.cpp, read in place and never written).

The C++ compiler links the three sources into one library,
`mhm2_proxy_tpu_torch/_build/<hash>/libmhm2_host.so`, at its first use in a
process, through _native_build.build_library (keyed by a hash of the
sources and flags, built under a temporary name and renamed into place),
with native/Makefile's flags, so that the merge is the same code as that
library's. Without a compiler, or where the build fails, the library is
not available, and the log says why once: the ingest falls back to the
pure-Python reader and the merge to the device merge (the reference's
CPU/GPU-style backend seam).

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared -o libmhm2_host.so \\
        csrc/fastq_into.cpp native/merge_native.cpp native/stitch_native.cpp -lpthread
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import numpy as np

from .. import _native_build

_PKG = Path(__file__).resolve().parent.parent
_NATIVE = _PKG.parent / "native"
SOURCES = (_PKG / "csrc" / "fastq_into.cpp", _NATIVE / "merge_native.cpp",
           _NATIVE / "stitch_native.cpp")
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_LIBS = ["-lpthread"]

_lib = None  # the loaded library; False once it could not be built or loaded

P = ctypes.c_void_p
I32 = ctypes.c_int32
I64 = ctypes.c_int64
_SIGNATURES = {  # entry point -> (restype, argtypes)
    "fastq_parse_into": (I64, [P, I64, I64, I32, I64, I64, I64, ctypes.c_uint8, P, P, P, I64,
                               P, P, P]),
    "mhm2_merge_pairs": (I64, [P, P, P, P, P, P, I64, I64, I32, I32, P, P, P, P, P, P, P]),
    "stitch_walk": (I64, [I64, I32, P, P, P, P, I64, P, P, P, I64]),
}


def _compile(tmp: Path):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return "", "no C++ compiler (g++, c++) on PATH"
    return _native_build.run([cxx, *_CXXFLAGS, "-o", str(tmp), *map(str, SOURCES), *_LIBS])


def _load():
    """The host library, built first if needed, or None."""
    global _lib
    if _lib is None:
        try:
            so, _ = _native_build.build_library("libmhm2_host.so", SOURCES, _CXXFLAGS + _LIBS,
                                                _compile)
            lib = ctypes.CDLL(str(so))
        except (OSError, RuntimeError) as e:
            from ..utils.logger import get_logger

            lines = str(e).splitlines() or [repr(e)]  # the first names build.log
            why = "\n  ".join(lines[:1] + lines[1:][-5:])
            get_logger().warning("the host library (io/native.py) did not build or load, so the "
                                 "ingest runs the Python reader and the merge the device merge:"
                                 f"\n  {why}")
            lib = False
        else:
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
        _lib = lib
    return _lib or None


def get_stitch_walk():
    """Callable wrapping the native sequential stitcher, or None.

    Signature: walk(succ (S,) i64, base (S,) u8, counts (n,) i32, k,
    out_buf u8, out_start i64, out_nstates i64, out_depth i64) -> n_paths.
    """
    lib = _load()
    if lib is None:
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


def parse_into_available() -> bool:
    return _load() is not None


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
    got = _load().fastq_parse_into(
        p(buf), buf.size, offset, int(final), row0, B, L, qual_pad,
        p(codes), p(quals), p(lens),
        0 if hdrs is None else hdrs.shape[1], p(hdrs), p(hdr_lens), p(out),
    )
    return int(got), int(out[0]), int(out[1]), int(out[2]), int(out[3])


def merge_available() -> bool:
    return _load() is not None


def merge_pairs(codes1, quals1, len1, codes2, quals2, len2, qual_offset=33,
                n_threads: int | None = None):
    """Native paired-read merge (native/merge_native.cpp).

    Same result dict contract as io.merge.merge_pairs_block (numpy arrays):
    merged, m_codes, m_quals, m_len, overlap, quals1_z, quals2_z,
    n_ambiguous.
    """
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
    n_ambig = _load().mhm2_merge_pairs(
        p(c1), p(q1), p(l1), p(c2), p(q2), p(l2),
        B, L, qual_offset, n_threads,
        p(merged), p(m_codes), p(m_quals), p(m_len), p(overlap), p(q1z), p(q2z),
    )
    return dict(
        merged=merged.astype(bool), m_codes=m_codes, m_quals=m_quals,
        m_len=m_len, overlap=overlap, quals1_z=q1z, quals2_z=q2z,
        n_ambiguous=int(n_ambig),
    )
