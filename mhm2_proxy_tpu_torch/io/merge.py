"""Paired-read merging (reference src/merge_reads.cpp:237-495).

Merging is a host-side ingest stage: its inputs and outputs live in numpy
(PackedReads). The production path is the shared native C++ scan
(native/merge_native.cpp). The block-vectorized tensor formulation that the
JAX package keeps as its fallback (mhm2_proxy_tpu/io/merge.py:300-323) is
not ported yet: ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import numpy as np


def merge_reads_arrays(codes1, quals1, len1, codes2, quals2, len2, qual_offset=33):
    """Merge a block of read pairs; returns the per-pair result dict as
    numpy arrays (same contract as mhm2_proxy_tpu.io.merge)."""
    from . import native

    if not native.merge_available():
        raise NotImplementedError(
            "pair merging without the native library (native/libmhm2_native.so) "
            "is not ported yet: ROADMAP queue 1 item 10"
        )
    return native.merge_pairs(
        np.asarray(codes1), np.asarray(quals1), np.asarray(len1),
        np.asarray(codes2), np.asarray(quals2), np.asarray(len2),
        qual_offset=qual_offset,
    )
