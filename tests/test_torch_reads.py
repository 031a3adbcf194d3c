"""PackedReads.count_blocks, the counting blocks a job builds once: each
case holds them to PackedReads.blocks() with the quality cut applied, row
for row and length for length, and reads the `built_bytes` and
`reused_blocks` counters of every call."""

import numpy as np
import pytest
import torch

from mhm2_proxy_tpu_torch.io.reads import PackedReads
from mhm2_proxy_tpu_torch.utils import trace
from torch_common import one_torch_thread  # noqa: F401 (autouse fixture)

CUT = 33 + 20


def _add_reads(reads, rng, n, read_len, width):
    """n reads of 1..read_len bases in a (n, width) block, a tenth of the
    rows empty placeholders, the padding past each read left as noise."""
    lens = rng.integers(1, read_len + 1, n).astype(np.int32)
    lens[rng.random(n) < 0.1] = 0
    codes = rng.integers(0, 5, (n, width)).astype(np.uint8)
    quals = rng.integers(33, 75, (n, width)).astype(np.uint8)
    reads.add_block(codes, quals, lens)


def _reads(read_len):
    """Three source blocks of unequal rows and widths (the last one wider
    than the counting blocks' L when the reads are 150 bp)."""
    rng = np.random.default_rng(read_len)
    reads = PackedReads()
    for n, width in ((70, read_len), (33, read_len + 3), (101, read_len + 40)):
        _add_reads(reads, rng, n, read_len, width)
    return reads


def _call(reads, rows, L, k, n_blocks=0):
    """(blocks, counters) of one count_blocks call."""
    with trace.recording(syncs=False):
        with trace.span("call") as sp:
            got = list(reads.count_blocks(rows, L, CUT, min_len=k, n_blocks=n_blocks))
    return got, sp.counters


def _assert_equal_to_packed(reads, got, rows, L, k):
    want = list(reads.blocks(rows, pad_len=L, min_len=k))
    assert len(got) >= len(want) == reads.n_blocks(rows)
    for (codes, ok, lens), (w_codes, w_quals, w_lens) in zip(got, want):
        assert isinstance(codes, torch.Tensor) and codes.dtype == torch.uint8
        assert ok.dtype == torch.bool and lens.dtype == np.int32
        assert np.array_equal(codes.numpy(), w_codes)
        assert np.array_equal(ok.numpy(), w_quals >= CUT)
        assert np.array_equal(lens, w_lens)
    return got[len(want):]


def _storage(blocks):
    return {c.untyped_storage().data_ptr() for c, _, _ in blocks}


CASES = ("ladder", "halved_rows", "wider_L", "reads_added", "padding")


@pytest.mark.parametrize("case", CASES)
def test_count_blocks_equal_the_packed_blocks(case):
    """ladder: k = 21, 55, 99 at one L build once and reuse every block;
    halved_rows: half the rows are row slices of the built blocks; wider_L:
    100 bp reads at k = 99 take L = 131 against 128 at k = 21, a rebuild;
    reads_added: add_block drops the built blocks; padding: the blocks past
    the reads' own are all-4 / all-false / zero, one block built once."""
    reads = _reads(100 if case == "wider_L" else 150)
    rows, L = 64, 160
    if case == "wider_L":
        L = 128
    first, c1 = _call(reads, rows, L, 21)
    assert _assert_equal_to_packed(reads, first, rows, L, 21) == []
    assert c1["built_bytes"] == reads.n_blocks(rows) * rows * (2 * L + 4)
    assert "reused_blocks" not in c1
    if case == "ladder":
        for k in (55, 99):
            again, c = _call(reads, rows, L, k)
            assert _assert_equal_to_packed(reads, again, rows, L, k) == []
            assert "built_bytes" not in c and c["reused_blocks"] == len(first)
            assert _storage(again) == _storage(first)
    elif case == "halved_rows":
        half, c = _call(reads, rows // 2, L, 33)
        assert _assert_equal_to_packed(reads, half, rows // 2, L, 33) == []
        assert "built_bytes" not in c and c["reused_blocks"] == len(half)
        assert _storage(half) == _storage(first)
    elif case == "wider_L":
        wide, c = _call(reads, rows, 131, 99)
        assert _assert_equal_to_packed(reads, wide, rows, 131, 99) == []
        assert c["built_bytes"] == len(wide) * rows * (2 * 131 + 4)
        assert "reused_blocks" not in c
    elif case == "reads_added":
        _add_reads(reads, np.random.default_rng(5), 90, 150, 150)
        more, c = _call(reads, rows, L, 21)
        assert len(more) > len(first)
        assert _assert_equal_to_packed(reads, more, rows, L, 21) == []
        assert c["built_bytes"] == len(more) * rows * (2 * L + 4)
    else:
        n = len(first)
        for call in range(2):
            got, c = _call(reads, rows, L, 21, n_blocks=n + 2)
            pad = _assert_equal_to_packed(reads, got, rows, L, 21)
            assert len(pad) == 2
            for codes, ok, lens in pad:
                assert codes.shape == ok.shape == (rows, L) and lens.shape == (rows,)
                assert bool((codes == 4).all()) and not bool(ok.any()) and not lens.any()
            # one padding block, built by the first of these calls
            assert c.get("built_bytes", 0) == (rows * (2 * L + 4) if call == 0 else 0)
            assert c["reused_blocks"] == n + 2 - (1 if call == 0 else 0)
