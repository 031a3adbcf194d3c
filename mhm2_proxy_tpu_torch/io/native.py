"""ctypes bindings for the native FASTQ layer (native/fastq_native.cpp).

Builds on demand with make; falls back to the pure-Python reader when the
toolchain or .so is unavailable (the reference's CPU/GPU-style backend seam
applied to ingest).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SO_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libmhm2_native.so"))

_lib = None


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
    lib.fastq_resync.restype = ctypes.c_int64
    lib.fastq_resync.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
    lib.fastq_parse_block.restype = ctypes.c_int64
    lib.fastq_parse_block.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint8,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fastq_scan.restype = ctypes.c_int64
    lib.fastq_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
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


def native_available() -> bool:
    return _load() is not None


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


def resync(buf: bytes, start: int) -> int:
    lib = _load()
    return int(lib.fastq_resync(buf, len(buf), start))


def scan(buf: bytes, offset: int = 0) -> tuple[int, int]:
    """(record_count, max_seq_len) from offset."""
    lib = _load()
    ml = ctypes.c_int64(0)
    cnt = lib.fastq_scan(buf, len(buf), offset, ctypes.byref(ml))
    return int(cnt), int(ml.value)


def parse_blocks(buf: bytes, block_reads: int, pad_len: int, qual_pad: int = 33,
                 offset: int = 0):
    """Yield (codes (B,L) u8, quals (B,L) u8, lens (B,) i32) blocks."""
    lib = _load()
    n = len(buf)
    while offset < n:
        codes = np.empty((block_reads, pad_len), np.uint8)
        quals = np.empty((block_reads, pad_len), np.uint8)
        lens = np.empty((block_reads,), np.int32)
        nxt = ctypes.c_int64(0)
        got = lib.fastq_parse_block(
            buf, n, offset, block_reads, pad_len, qual_pad,
            codes.ctypes.data_as(ctypes.c_void_p),
            quals.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(nxt),
        )
        if got == 0:
            break
        yield codes, quals, lens, int(got)
        offset = int(nxt.value)
