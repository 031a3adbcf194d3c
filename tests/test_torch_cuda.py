"""The port's CUDA kernels against their plain versions, on the card.

Each case runs a kernel's wrapper on CUDA tensors and the same wrapper on
CPU copies (which takes the plain version), and requires bit-equal integer
results (tolerance 0). The shapes are small but pick the edges the kernels'
block decompositions have: empty runs, lengths that are not block
multiples, equal-key runs and group sums that span many blocks, and the u16
clamp. Every test takes the `cuda` fixture, which skips it when there is
no CUDA device. The repo's conftest imports jax, which the GPU machine
lacks, so run them there without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mhm2_proxy_tpu_torch.constants import MAX_KMER_COUNT, words32_for_k
from mhm2_proxy_tpu_torch.ops import (compact, extract, finalize, join, kernels, lookup, scan,
                                      sort, ssw)
from mhm2_proxy_tpu_torch.ops.u32 import lexsort_lanes
from torch_common import RANGE_CUT_CASES, SCORING_WIDE, SCORINGS_ALL, range_cut_runs

# the ssw kernel's strip width (csrc/ssw.cu's kStrip), for shapes at its edges
SSW_STRIP = 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32))


def _launched(name, fn):
    before = kernels.launches()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launches()[name] == before + 1
    return out


def _same(got, want, rows=None):
    for g, w in zip(got, want):
        g = g.cpu()
        if rows is not None:
            g, w = g[:rows], w[:rows]
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.parametrize("k,packed", [(k, p) for k in (21, 33, 55, 99) for p in (True, False)]
                         + [(63, False), (77, False)])
def test_extract(cuda, k, packed):
    rng = np.random.default_rng(k + packed)
    for B, L in ((37, k + 45), (3, 2048)):
        codes = torch.from_numpy(rng.integers(0, 5, (B, L), dtype=np.uint8))
        qual = torch.from_numpy(rng.random((B, L)) > 0.1)
        lens = torch.from_numpy(rng.integers(k - 2, L + 1, B).astype(np.int32))
        want = extract._extract(codes, qual, lens, k, packed)
        got = _launched("extract", lambda: extract._extract(
            codes.to(cuda), qual.to(cuda), lens.to(cuda), k, packed))
        _same(got, want)


@pytest.mark.parametrize("k", [15, 16, 17, 31, 32, 33, 63, 64, 77])
@pytest.mark.parametrize("dl", [-1, 0, 1])
@pytest.mark.parametrize("packed", [True, False])
def test_extract_stream_edges(cuda, k, dl, packed):
    """Read lengths around 16-base stream words (L = 16m - 1, 16m, 16m + 1:
    rows that are and are not whole 16-byte loads), lens from k - 2 to L,
    N and low-quality bases at both ends of every read."""
    rng = np.random.default_rng(k * 10 + dl + 3 * packed)
    L = 16 * (k // 16 + 2) + dl
    B = 41
    codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.05] = 4
    qual = rng.random((B, L)) > 0.1
    lens = rng.integers(k - 2, L + 1, B).astype(np.int32)
    lens[:3] = (L, k + 1, k + 2)
    for b in range(B):
        codes[b, [0, lens[b] - 1]] = 4 if b % 2 else codes[b, [0, lens[b] - 1]]
        qual[b, [0, 1, lens[b] - 2, lens[b] - 1]] = b % 3 == 0
    args = tuple(map(torch.from_numpy, (codes, qual, lens)))
    want = extract._extract(*args, k, packed)
    got = _launched("extract", lambda: extract._extract(*(x.to(cuda) for x in args), k, packed))
    _same(got, want)


def _sorted_run(rng, n, n_lanes, kw, n_keys):
    """A lexsorted run over few distinct keys (long equal-key runs), keys
    with bit 31 set, and an all-ones sentinel tail."""
    keys = rng.integers(0, 1 << 32, (max(n_keys, 1), kw), dtype=np.uint64).astype(np.uint32)
    keys[: len(keys) // 2, 0] |= np.uint32(0x80000000)
    rows = np.concatenate(
        [keys[rng.integers(0, len(keys), n)],
         rng.integers(0, 1 << 32, (n, n_lanes - kw), dtype=np.uint64).astype(np.uint32)], 1)
    rows[n - n // 10 :, :kw] = 0xFFFFFFFF
    return lexsort_lanes(tuple(_i32(rows[:, i]) for i in range(n_lanes)), kw)


@pytest.mark.parametrize("na,nb,kw,n_lanes,n_keys", [
    (0, 5, 2, 2, 3),
    (7, 0, 1, 3, 3),
    (1, 1, 2, 2, 2),
    (1023, 1025, 3, 3, 5000),
    (3000, 7001, 2, 3, 4),          # equal-key runs across many tiles
    (4095, 4096, 4, 5, 900),        # two 4096-row tiles less one row
    (4097, 4096, 4, 5, 900),        # and one more
    (1000, 2072, 3, 8, 700),        # W + 5 lanes (split sets)
    (2048, 2047, 5, 6, 400),        # key lanes + payload (k = 77 raw runs): 2048-row tiles
    (2048, 2049, 5, 6, 400),
])
def test_merge(cuda, na, nb, kw, n_lanes, n_keys):
    rng = np.random.default_rng(na + nb + kw)
    a = _sorted_run(rng, na, n_lanes, kw, n_keys)
    b = _sorted_run(rng, nb, n_lanes, kw, n_keys)
    want = sort.merge_sorted_lanes(a, b, kw)
    got = _launched("sort", lambda: sort.merge_sorted_lanes(
        tuple(x.to(cuda) for x in a), tuple(x.to(cuda) for x in b), kw))
    _same(got, want)


@pytest.mark.parametrize("kw", range(1, 9))
def test_merge_key_widths(cuda, kw):
    """kw = 1 to 8 with 16 lanes, over few keys: equal-key runs straddle
    the tile and partition boundaries; lengths a tile multiple plus and
    minus one."""
    tile = 4096 if kw <= 4 else 2048
    rng = np.random.default_rng(kw)
    a = _sorted_run(rng, 3 * tile + 1, 16, kw, 3)
    b = _sorted_run(rng, 2 * tile - 1, 16, kw, 3)
    want = sort.merge_sorted_lanes(a, b, kw)
    got = _launched("sort", lambda: sort.merge_sorted_lanes(
        tuple(x.to(cuda) for x in a), tuple(x.to(cuda) for x in b), kw))
    _same(got, want)


@pytest.mark.parametrize("W,n_pay", [(2, 5), (4, 1), (8, 2)])
def test_merge_strided_words(cuda, W, n_pay):
    """Key lanes read in place from row-major (N, W) words (and a payload
    lane that is a strided column too), written back as (N, W)."""
    rng = np.random.default_rng(W)
    a = _sorted_run(rng, 9001, W + n_pay, W, 2000)
    b = _sorted_run(rng, 5003, W + n_pay, W, 2000)
    want = sort.merge_sorted_lanes(a, b, W)
    wa, wb = (torch.stack(x, 1).to(cuda) for x in (a, b))
    got = _launched("sort", lambda: sort.merge_sorted_lanes(
        tuple(wa[:, i] for i in range(W + n_pay)), tuple(wb[:, i] for i in range(W + n_pay)), W,
        as_words=True))
    assert got[0].shape == (14004, W) and got[0].is_contiguous()
    _same(tuple(got[0].T) + tuple(got[1:]), want)


def test_merge_1120_tiles(cuda):
    """The k = 21 merge-tree shape: 7,340,032 + 29,360,128 rows, kw = 2."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1120)
    runs = []
    for n in (7_340_032, 29_360_128):
        keys = torch.randint(-2**31, 2**31, (n, 2), dtype=torch.int32, device=cuda, generator=gen)
        keys[: n // 3, 0] = keys[: n // 3, 0] & 0xFF  # equal keys across the runs
        runs.append(lexsort_lanes((keys[:, 0], keys[:, 1])))
    want = sort._merge_plain(runs[0], runs[1], 2, False)
    got = _launched("sort", lambda: sort.merge_sorted_lanes(runs[0], runs[1], 2))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _packed_run(rng, k, n, n_keys):
    """A sorted packed run: few distinct keys (groups spanning blocks), the
    7-bit payload in the last lane's free bits, a sentinel tail."""
    weff = -(-2 * k // 32)
    free = 32 * weff - 2 * k
    keys = rng.integers(0, 1 << 32, (n_keys, weff), dtype=np.uint64).astype(np.uint32)
    keys[:, -1] &= np.uint32((0xFFFFFFFF >> free) << free)
    rows = keys[rng.integers(0, n_keys, n)]
    pay = 1 | (rng.integers(0, 6, n) << 1) | (rng.integers(0, 6, n) << 4)
    rows[:, -1] |= pay.astype(np.uint32)
    rows[n - n // 20 :] = 0xFFFFFFFF
    return lexsort_lanes(tuple(_i32(rows[:, i]) for i in range(weff)))


def _finalize_same(cuda, lanes, k, purge, pay=None):
    """scan_purge_compact on the card (one launch) equals the plain version:
    words, payload lanes and the kept count."""
    W = words32_for_k(k)
    want = finalize.scan_purge_compact(lanes, k, W, purge=purge, pay=pay)
    got = _launched("finalize", lambda: finalize.scan_purge_compact(
        tuple(x.to(cuda) for x in lanes), k, W, purge=purge,
        pay=None if pay is None else pay.to(cuda)))
    assert len(got) == len(want)
    _same(got, want)
    return int(want[-1])


@pytest.mark.parametrize("k", [21, 33, 55, 99])
@pytest.mark.parametrize("purge", [True, False])
def test_finalize(cuda, k, purge):
    rng = np.random.default_rng(k * 2 + purge)
    # n_keys=2 over 70001 rows: groups of ~33k rows span ~33 blocks; one
    # key of 68400 rows (72000 less the sentinel tail) passes the u16 clamp
    for n, n_keys in ((1, 1), (3001, 300), (70001, 2), (72000, 1)):
        _finalize_same(cuda, _packed_run(rng, k, n, n_keys), k, purge)


def _sep_run(rng, k, n, n_keys):
    """A key-sorted separate-payload run: weff key lanes (a few distinct
    keys), the payload lane count | left<<16 | right<<24 (count 1-3), and
    a sentinel tail (all-ones keys, payload 0)."""
    weff = -(-2 * k // 32)
    keys = rng.integers(0, 1 << 32, (n_keys, weff), dtype=np.uint64).astype(np.uint32)
    keys[: n_keys // 2, 0] |= np.uint32(0x80000000)
    rows = keys[rng.integers(0, n_keys, n)]
    pay = (rng.integers(1, 4, n) | (rng.integers(0, 6, n) << 16)
           | (rng.integers(0, 6, n) << 24)).astype(np.uint32)
    rows[n - n // 20 :] = 0xFFFFFFFF
    pay[n - n // 20 :] = 0
    return lexsort_lanes(tuple(_i32(rows[:, i]) for i in range(weff)) + (_i32(pay),), weff)


@pytest.mark.parametrize("k", [63, 77])
@pytest.mark.parametrize("purge", [True, False])
def test_finalize_separate_payload(cuda, k, purge):
    rng = np.random.default_rng(k * 3 + purge)
    # 30000 rows of 2 keys at count 1-3: groups span ~15 blocks, past the clamp
    for n, n_keys in ((1, 1), (3001, 300), (30001, 2)):
        lanes = _sep_run(rng, k, n, n_keys)
        _finalize_same(cuda, lanes[:-1], k, purge, pay=lanes[-1])


FINALIZE_TILE = scan.TILE_ROWS


def _group_run(rng, k, idx, sep, n_sent=0, ext=None):
    """A sorted run whose row r holds the idx[r]-th smallest of idx.max() + 1
    random keys (idx non-decreasing), then n_sent sentinel rows: packed (the
    7-bit payload in the last lane's free bits) or, with sep, weff key lanes
    and a count-1 payload lane. ext: (left, right) codes per row, random
    0-5 by default."""
    weff = -(-2 * k // 32)
    free = 32 * weff - 2 * k
    n_keys = int(idx.max()) + 1 if len(idx) else 0
    keys = rng.integers(0, 1 << 32, (2 * n_keys + 8, weff), dtype=np.uint64).astype(np.uint32)
    if not sep:
        keys[:, -1] &= np.uint32((0xFFFFFFFF >> free) << free)
    keys = np.unique(keys, axis=0)
    keys = keys[(keys != 0xFFFFFFFF).any(1)][:n_keys]  # no all-ones (sentinel) key
    left, right = ext if ext is not None else (rng.integers(0, 6, len(idx)),
                                               rng.integers(0, 6, len(idx)))
    rows = np.full((len(idx) + n_sent, weff), 0xFFFFFFFF, np.uint32)
    rows[: len(idx)] = keys[idx]
    if sep:
        pay = np.zeros(len(rows), np.uint32)
        pay[: len(idx)] = 1 | (np.asarray(left) << 16) | (np.asarray(right) << 24)
        return tuple(_i32(rows[:, i]) for i in range(weff)), _i32(pay)
    rows[: len(idx), -1] |= (1 | (np.asarray(left) << 1) | (np.asarray(right) << 4)).astype(
        np.uint32)
    return tuple(_i32(rows[:, i]) for i in range(weff)), None


def _finalize_case(rng, case, purge):
    """(group index per row, sentinel rows, ext codes or None, the kept
    count the case must give or None)."""
    T = FINALIZE_TILE
    if case == "none kept":  # sentinels only; with purge also count-1 keys only
        n = 3 * T + 5
        return (np.arange(n) if purge else np.zeros(0, np.int64)), (0 if purge else n), None, 0
    if case == "all kept":  # no purge: distinct keys, no sentinels
        n = 2 * T + 7
        return np.arange(n), 0, None, (None if purge else n)
    if case == "only N-1 kept":  # count-1 keys (purge) or one group (no purge), then a
        n = 2 * T + 1  # count-2 group ending at the last row, both rows calling left A
        idx = np.concatenate([np.arange(n - 2), [n - 2, n - 2]]) if purge else np.zeros(n, int)
        left = np.where(np.arange(n) >= n - 2, 0, 5)
        return idx, 0, (left, np.full(n, 5)), 1
    if case == "pairs at tile edges":  # count-2 groups ending on odd rows, then on
        n = 3 * T  # even rows: kept rows at 2047, 2048, 4095, 4096, ...
        r = np.arange(n)
        idx = np.where(r < T + 3, r // 2, (r + 1) // 2)  # and one count-1 group, row 2050
        groups = np.bincount(idx)
        return idx, 40, (np.zeros(n, int), np.full(n, 3)), int(
            (groups >= 2).sum() if purge else len(groups))
    t, d = {"N = 2048 - 1": (1, -1), "N = 2048 + 1": (1, 1), "N = 3 x 2048 - 1": (3, -1),
            "N = 3 x 2048 + 1": (3, 1)}[case]
    n = t * T + d
    sizes = rng.integers(1, 5, n)
    idx = np.repeat(np.arange(n), sizes)[:n]
    return idx, n // 50, None, None


@pytest.mark.parametrize("case", ["none kept", "all kept", "only N-1 kept",
                                  "pairs at tile edges", "N = 2048 - 1", "N = 2048 + 1",
                                  "N = 3 x 2048 - 1", "N = 3 x 2048 + 1"])
@pytest.mark.parametrize("purge", [True, False])
@pytest.mark.parametrize("k", [21, 77])
def test_finalize_edges(cuda, case, purge, k):
    """The fused kernel's tile edges: no kept row, every row kept, the only
    kept row at N - 1, kept rows on both sides of tile edges, and N one off
    a multiple of the 2048-row tile; packed at k = 21, a separate payload
    at k = 77."""
    rng = np.random.default_rng(len(case) * 4 + purge * 2 + k)
    idx, n_sent, ext, kept = _finalize_case(rng, case, purge)
    # the tail's sentinels keep N one off the tile multiple
    if case.startswith("N ="):
        idx = idx[: len(idx) - n_sent]
    keys, pay = _group_run(rng, k, idx, k == 77, n_sent, ext)
    n_kept = _finalize_same(cuda, keys, k, purge, pay)
    if kept is not None:
        assert n_kept == kept


@pytest.mark.parametrize("n,p_start", [(1, 1.0), (1023, 0.3), (1025, 1.0), (70001, 0.0005),
                                       (5000, 0.9)])
def test_scan_lanes(cuda, n, p_start):
    rng = np.random.default_rng(n)
    is_start = torch.from_numpy(rng.random(n) < p_start)
    pays = tuple(torch.from_numpy(rng.integers(0, 1 << v, n).astype(np.int32))
                 for v in (0, 1, 3, 8, 12, 16, 20, 24, 30))
    want = scan.group_sums_scan_lanes(pays, is_start, MAX_KMER_COUNT)
    got = _launched("scan", lambda: scan.group_sums_scan_lanes(
        tuple(x.to(cuda) for x in pays), is_start.to(cuda), MAX_KMER_COUNT))
    _same(got, want)


def test_scan_one_group_past_the_clamp(cuda):
    """One group over ~100 blocks: the carry chain and the saturation (the
    30-bit lane's exact sum passes 2^31 within the group)."""
    n = 100_000
    is_start = torch.zeros(n, dtype=torch.bool)
    is_start[0] = True
    pays = (torch.ones(n, dtype=torch.int32), torch.full((n,), 1 << 30, dtype=torch.int32))
    want = scan.group_sums_scan_lanes(pays, is_start, MAX_KMER_COUNT)
    got = _launched("scan", lambda: scan.group_sums_scan_lanes(
        tuple(x.to(cuda) for x in pays), is_start.to(cuda), MAX_KMER_COUNT))
    _same(got, want)
    assert int(got[0][-1]) == MAX_KMER_COUNT


@pytest.mark.parametrize("k", [21, 33, 55, 99])
@pytest.mark.parametrize("n,n_keys", [(1, 1), (3001, 300), (70001, 2), (72000, 1)])
def test_scan_packed(cuda, k, n, n_keys):
    rng = np.random.default_rng(k + n)
    lanes = _packed_run(rng, k, n, n_keys)
    keymask = finalize._keymask(k, len(lanes))
    want = scan.group_sums_scan_packed(lanes, keymask, MAX_KMER_COUNT)
    got = _launched("scan", lambda: scan.group_sums_scan_packed(
        tuple(x.to(cuda) for x in lanes), keymask, MAX_KMER_COUNT))
    _same(got, want)


def test_scan_empty(cuda):
    before = kernels.launches()["scan"]
    e = torch.zeros((0,), dtype=torch.int32, device=cuda)
    got = scan.group_sums_scan_lanes((e,) * 9, torch.zeros((0,), dtype=torch.bool, device=cuda),
                                     MAX_KMER_COUNT)
    got += scan.group_sums_scan_packed((e, e), 0xFFFFFC00, MAX_KMER_COUNT)
    assert all(x.shape == (0,) for x in got) and kernels.launches()["scan"] == before


# csrc/scan.cu's tile (kTile) and csrc/join.cu's window (kWin: a tile of
# kWin - 2 reach rows and two halos of reach rows) and kMaxReach
SCAN_TILE = scan.TILE_ROWS
JOIN_WINDOW = 1536
JOIN_MAX_REACH = join.MAX_KERNEL_REACH


@pytest.mark.parametrize("n", [SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1, 2 * SCAN_TILE - 1,
                               2 * SCAN_TILE + 1])
@pytest.mark.parametrize("n_pay", [1, 9])
def test_scan_lanes_tile_edges(cuda, n, n_pay):
    """Lengths at the tile's edges, groups across them, n_pay 1 (the sharded
    path's one lane) and 9 (the 16-bit form's odd last half)."""
    rng = np.random.default_rng(n + n_pay)
    is_start = torch.from_numpy(rng.random(n) < 0.002)
    pays = tuple(torch.from_numpy(rng.integers(0, 1 << 10, n).astype(np.int32))
                 for _ in range(n_pay))
    want = scan.group_sums_scan_lanes(pays, is_start, MAX_KMER_COUNT)
    got = _launched("scan", lambda: scan.group_sums_scan_lanes(
        tuple(x.to(cuda) for x in pays), is_start.to(cuda), MAX_KMER_COUNT))
    _same(got, want)


@pytest.mark.parametrize("form", ["lanes", "packed"])
def test_scan_group_over_1000_tiles(cuda, form):
    """One group over more than 1,000 tiles: every tile's carry comes
    through the look-back (its nearest inclusive prefix)."""
    n = 1001 * SCAN_TILE + 5
    rng = np.random.default_rng(1001)
    if form == "lanes":
        is_start = torch.zeros(n, dtype=torch.bool)
        is_start[0] = True
        is_start[n - 3] = True
        pays = (torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)),
                torch.from_numpy((rng.random(n) < 1e-5).astype(np.int32)))
        want = scan.group_sums_scan_lanes(pays, is_start, MAX_KMER_COUNT)
        got = _launched("scan", lambda: scan.group_sums_scan_lanes(
            tuple(x.to(cuda) for x in pays), is_start.to(cuda), MAX_KMER_COUNT))
        assert 0 < int(want[1][n - 4]) < MAX_KMER_COUNT
    else:
        lanes = _packed_run(rng, 21, n, 1)
        keymask = finalize._keymask(21, len(lanes))
        want = scan.group_sums_scan_packed(lanes, keymask, MAX_KMER_COUNT)
        got = _launched("scan", lambda: scan.group_sums_scan_packed(
            tuple(x.to(cuda) for x in lanes), keymask, MAX_KMER_COUNT))
    _same(got, want)


@pytest.mark.parametrize("clamp", [0, 1000, MAX_KMER_COUNT, MAX_KMER_COUNT + 1, 1 << 20,
                                   (1 << 31) - 1])
def test_scan_inputs_past_the_halves(cuda, clamp):
    """Inputs past 0xFFFF: at a clamp <= 0xFFFF the 16-bit form clamps each
    input before its saturating adds; above, the 32-bit form saturates at
    INT32_MAX (the exact sums pass 2^31 here)."""
    n = 3 * SCAN_TILE + 77
    rng = np.random.default_rng(clamp % 1000)
    is_start = torch.from_numpy(rng.random(n) < 0.001)
    pays = tuple(torch.from_numpy(rng.integers(0, 1 << v, n).astype(np.int32))
                 for v in (4, 15, 16, 17, 20, 24, 28, 30, 31))
    want = scan.group_sums_scan_lanes(pays, is_start, clamp)
    got = _launched("scan", lambda: scan.group_sums_scan_lanes(
        tuple(x.to(cuda) for x in pays), is_start.to(cuda), clamp))
    _same(got, want)
    assert clamp == 0 or bool((want[8] == clamp).any())


def test_scan_calls_back_to_back(cuda):
    """Calls one after another, of both forms and several sizes, without a
    synchronise: each takes its tiles from the ticket the last one reset,
    and its generation makes the last one's status words stale."""
    rng = np.random.default_rng(5)
    cases = []
    for n in (5 * SCAN_TILE + 3, 700, 2 * SCAN_TILE, 9 * SCAN_TILE + 1):
        is_start = torch.from_numpy(rng.random(n) < 0.0005)
        pays = tuple(torch.from_numpy(rng.integers(0, 300, n).astype(np.int32)) for _ in range(3))
        lanes = _packed_run(rng, 33, n, 7)
        cases.append((is_start, pays, lanes))
    wants, gots = [], []
    for is_start, pays, lanes in cases:
        keymask = finalize._keymask(33, len(lanes))
        wants.append(scan.group_sums_scan_lanes(pays, is_start, MAX_KMER_COUNT)
                     + scan.group_sums_scan_packed(lanes, keymask, MAX_KMER_COUNT))
        gots.append(scan.group_sums_scan_lanes(tuple(x.to(cuda) for x in pays),
                                               is_start.to(cuda), MAX_KMER_COUNT)
                    + scan.group_sums_scan_packed(tuple(x.to(cuda) for x in lanes), keymask,
                                                  MAX_KMER_COUNT))
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        _same(got, want)


@pytest.mark.parametrize("n", [1, 1024, 3000, 70001])
def test_compact_emit_lanes(cuda, n):
    """The split's 3-class compaction: multis write W + 5 lanes, singles W + 1."""
    rng = np.random.default_rng(n + 7)
    W = 4
    lanes = tuple(_i32(rng.integers(0, 1 << 32, n, dtype=np.uint64)) for _ in range(W + 5))
    flags = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    sel = (tuple(range(W + 5)), tuple(range(W + 1)))
    want = compact.compact_classes(lanes, flags, 3, (0, 1), sel)
    got = _launched("compact", lambda: compact.compact_classes(
        tuple(x.to(cuda) for x in lanes), flags.to(cuda), 3, (0, 1), sel))
    for (gl, gn), (wl, wn), s in zip(got, want, sel):
        assert int(gn) == int(wn) and len(gl) == len(s)
        _same(gl, wl, rows=int(wn))


@pytest.mark.parametrize("n", [1, 1000, 1025, 5000])
@pytest.mark.parametrize("n_classes,emit", [(1, (0,)), (2, (0,)), (3, (0, 2)), (4, (3, 1, 0))])
def test_compact(cuda, n, n_classes, emit):
    rng = np.random.default_rng(n + n_classes)
    lanes = tuple(_i32(rng.integers(0, 1 << 32, n, dtype=np.uint64)) for _ in range(3))
    flags = torch.from_numpy(rng.integers(0, n_classes, n).astype(np.int32))
    want = compact.compact_classes(lanes, flags, n_classes, emit)
    got = _launched("compact", lambda: compact.compact_classes(
        tuple(x.to(cuda) for x in lanes), flags.to(cuda), n_classes, emit))
    for (gl, gn), (wl, wn) in zip(got, want):
        assert int(gn) == int(wn)
        _same(gl, wl, rows=int(wn))


@pytest.mark.parametrize("n,kw,n_keys,max_dup,q_frac", [
    (0, 2, 1, 32, 0.6),
    (1, 1, 1, 32, 0.6),
    (3001, 2, 300, 32, 0.6),
    (5000, 4, 40, 32, 0.99),  # runs of ~125 rows, few table rows: past the reach, across blocks
    (4097, 7, 2000, 129, 0.6),
    (2000, 3, 50, 1, 0.6),    # reach 0: only a query's own row
])
def test_join(cuda, n, kw, n_keys, max_dup, q_frac):
    rng = np.random.default_rng(n + kw + max_dup)
    keys = rng.integers(0, 1 << 32, (n_keys, kw), dtype=np.uint64).astype(np.uint32)
    keys[: n_keys // 2, 0] |= np.uint32(0x80000000)
    rows = keys[rng.integers(0, n_keys, n)]
    rows[n - n // 10 :] = 0xFFFFFFFF
    is_q = rng.random(n) < q_frac
    n_q = int(is_q.sum())
    qsrc = np.zeros(n, np.uint64)
    qsrc[is_q] = rng.permutation(n_q).astype(np.uint64) | join.QUERY_BIT
    tsrc = rng.integers(0, n + 1, n).astype(np.uint64) | (rng.integers(0, 64, n).astype(np.uint64) << 26)
    src = np.where(is_q, qsrc, tsrc).astype(np.uint32)
    lanes = lexsort_lanes(tuple(_i32(rows[:, i]) for i in range(kw)) + (_i32(src),), kw)
    n_valid = int(0.8 * n)
    want = join.propagate_answers(lanes, n_valid, kw, 6, n_q, max_dup)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=cuda)
    if n:
        got = _launched("join", lambda: join.propagate_answers(
            tuple(x.to(cuda) for x in lanes), nv, kw, 6, n_q, max_dup))
    else:
        got = join.propagate_answers(tuple(x.to(cuda) for x in lanes), nv, kw, 6, n_q, max_dup)
    _same((got,), (want,))
    hits = int((want != 0).sum())
    assert n < 1000 or (hits == 0 if max_dup == 1 else 0 < hits < n_q)


@pytest.mark.parametrize("n,kw,n_keys,max_dup,q_frac", [
    (1, 2, 1, 32, 0.6),
    (3001, 2, 300, 32, 0.6),
    (5000, 4, 40, 32, 0.99),  # runs of ~125 rows, few table rows: past the reach
    (4097, 7, 2000, 129, 0.6),
])
def test_join_separate_lanes(cuda, n, kw, n_keys, max_dup, q_frac):
    rng = np.random.default_rng(n + kw)
    keys = rng.integers(0, 1 << 32, (n_keys, kw), dtype=np.uint64).astype(np.uint32)
    keys[: n_keys // 2, 0] |= np.uint32(0x80000000)
    rows = keys[rng.integers(0, n_keys, n)]
    rows[n - n // 10 :] = 0xFFFFFFFF
    is_q = rng.random(n) < q_frac
    n_q = int(is_q.sum())
    src = rng.integers(0, n + 1, n).astype(np.uint32)
    src[is_q] = (rng.permutation(n_q) | join.SEP_QUERY_BIT).astype(np.uint32)
    pay = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    lanes = lexsort_lanes(tuple(_i32(rows[:, i]) for i in range(kw)) + (_i32(src), _i32(pay)), kw)
    n_valid = int(0.8 * n)
    want = join.propagate_answers_sep(lanes, n_valid, kw, n_q, max_dup)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=cuda)
    got = _launched("join", lambda: join.propagate_answers_sep(
        tuple(x.to(cuda) for x in lanes), nv, kw, n_q, max_dup))
    _same((got,), (want,))
    assert n < 1000 or 0 < int((want != 0).sum()) < n_q


def _join_runs(rng, run_lens, q_frac, kw=2, sep=False):
    """Merged rows whose equal-key runs have the given lengths, in key order
    (the last run all-ones), table and query rows mixed at random inside
    each run; the query ids are a permutation of 0..n_q-1."""
    n = int(sum(run_lens))
    keys = np.unique(rng.integers(0, 1 << 31, 2 * len(run_lens)))[: len(run_lens) - 1]
    assert len(keys) == len(run_lens) - 1
    keys = np.concatenate([keys, [0xFFFFFFFF]]).astype(np.uint32)
    rows = np.repeat(keys, run_lens)
    is_q = rng.random(n) < q_frac
    n_q = int(is_q.sum())
    ids = rng.permutation(n_q).astype(np.uint64)
    if sep:
        src = rng.integers(0, n + 1, n).astype(np.uint64)
        src[is_q] = ids | join.SEP_QUERY_BIT
        lanes = (rows,) * kw + (src, rng.integers(0, 1 << 32, n, dtype=np.uint64))
    else:
        src = rng.integers(0, n + 1, n).astype(np.uint64) | (
            rng.integers(0, 64, n).astype(np.uint64) << 26)
        src[is_q] = ids | join.QUERY_BIT
        lanes = (rows,) * kw + (src,)
    return tuple(_i32(x) for x in lanes), n_q


def _join_both(cuda, lanes, n_valid, kw, n_q, max_dup, sep, n_store=None):
    """The wrapper on CUDA (one launch) and on the CPU; n_store < n_q: only
    the answers of query ids below it are stored."""
    nv = torch.tensor(n_valid, dtype=torch.int32, device=cuda)
    Q = n_q if n_store is None else n_store
    # leave an all-ones block of the answers' size in the allocator's cache:
    # past one staging bucket the wrapper does not zero-fill, so every answer,
    # zero or not, must come from the kernel
    torch.full((Q,), -1, dtype=torch.int64 if sep else torch.int32, device=cuda)
    if sep:
        want = join.propagate_answers_sep(lanes, n_valid, kw, n_q, max_dup)[:Q]
        got = _launched("join", lambda: join.propagate_answers_sep(
            tuple(x.to(cuda) for x in lanes), nv, kw, Q, max_dup))
    else:
        want = join.propagate_answers(lanes, n_valid, kw, 6, n_q, max_dup)[:Q]
        got = _launched("join", lambda: join.propagate_answers(
            tuple(x.to(cuda) for x in lanes), nv, kw, 6, Q, max_dup))
    _same((got,), (want,))
    return want


@pytest.mark.parametrize("sep", [False, True])
def test_join_all_ones_run_past_tile_and_halos(cuda, sep):
    """build_edges' all-ones run (the queries of non-UU rows and the padded
    table rows), longer than a tile and both halos, between ordinary runs."""
    rng = np.random.default_rng(11 + sep)
    lens = list(rng.integers(1, 9, 3000)) + [3 * JOIN_WINDOW + 17]
    lanes, n_q = _join_runs(rng, lens, 0.6, sep=sep)
    n = lanes[0].shape[0]
    want = _join_both(cuda, lanes, int(0.7 * n), 2, n_q, 32, sep)
    assert 0 < int((want != 0).sum()) < n_q


@pytest.mark.parametrize("max_dup", [1, 32, 256])
@pytest.mark.parametrize("sep", [False, True])
def test_join_runs_at_tile_and_halo_edges(cuda, max_dup, sep):
    """Reach 0, 31 and 255: run boundaries exactly at tile edges, at a halo's
    edge (a tile edge +- reach, +- 1) and runs straddling tile edges, most
    rows queries (a run's few table rows lie far from many of them)."""
    r = join.reach(max_dup)
    rng = np.random.default_rng(max_dup + 2 * sep)
    cuts = set()
    for t in range(1, 6):
        e = t * (JOIN_WINDOW - 2 * r)
        for d in (0, -r, r, -r - 1, r + 1, -r + 1, r - 1, -3 * r - 5, 2 * r + 7):
            cuts.add(e + d)
    n = 6 * (JOIN_WINDOW - 2 * r) + 333
    cuts = sorted(c for c in cuts if 0 < c < n)
    lens = np.diff([0] + cuts + [n])
    lens = [int(x) for x in lens if x > 0]
    lanes, n_q = _join_runs(rng, lens, 0.9, sep=sep)
    want = _join_both(cuda, lanes, int(0.8 * n), 2, n_q, max_dup, sep)
    hits = int((want != 0).sum())
    assert hits == 0 if r == 0 else 0 < hits < n_q


@pytest.mark.parametrize("sep", [False, True])
def test_join_query_ids_past_q(cuda, sep):
    """Query rows whose ids are >= Q are not stored: the answers below Q
    are those of the whole query set."""
    rng = np.random.default_rng(3 + sep)
    lanes, n_q = _join_runs(rng, list(rng.integers(1, 40, 2000)), 0.6, kw=3, sep=sep)
    _join_both(cuda, lanes, int(0.8 * lanes[0].shape[0]), 3, n_q, 32, sep, n_store=n_q // 2)


@pytest.mark.parametrize("sep,n_q", [(False, 4_500_000), (True, 2_200_000), (True, 5_000_000)])
def test_join_staged_scatter(cuda, sep, n_q):
    """More answers than one 4 MB bucket holds (2^20 u32, 2^19 u64): the
    kernel stages (dest, answer) pairs by bucket, regroups them by 64 KB
    image and writes each image whole; one launch counted."""
    rng = np.random.default_rng(n_q + sep)
    n_runs = n_q // 3
    lens = list(rng.integers(1, 8, n_runs)) + [1000]
    lanes, got_q = _join_runs(rng, lens, 0.0, sep=sep)
    # the queries: n_q rows picked at random among the merged rows
    n = lanes[0].shape[0]
    src = lanes[2].numpy().view(np.uint32).copy()
    is_q = np.zeros(n, bool)
    is_q[rng.choice(n, min(n_q, n - 1000), replace=False)] = True
    ids = rng.permutation(int(is_q.sum())).astype(np.uint64)
    bit = join.SEP_QUERY_BIT if sep else join.QUERY_BIT
    src[is_q] = (ids | bit).astype(np.uint32)
    lanes = lanes[:2] + (_i32(src),) + lanes[3:]
    want = _join_both(cuda, lanes, int(0.8 * n), 2, int(is_q.sum()), 32, sep)
    assert 0 < int((want != 0).sum()) < len(want)


def test_join_past_2_28_queries(cuda):
    """270,000,000 queries in the separate-lane layout, past 2^28 (512
    staging buckets of 2^19 u64 answers): the staging runs in two passes of
    query-id windows, the second partial, and every answer equals the plain
    version's on the card (~20 GB)."""
    from mhm2_proxy_tpu_torch.ops.u32 import narrow

    n_runs = 90_000_000
    M = 4 * n_runs
    Q = M - n_runs
    assert Q > 1 << 28 and kernels.lib().mhm2_join_scratch_bytes(Q, 8) > 0
    gen = torch.Generator(device=cuda)
    gen.manual_seed(28)
    row = torch.arange(M, device=cuda)
    is_t = row % 4 == 0  # each run of 4 equal keys: one table row, 3 queries
    src = torch.where(is_t, row // 4, 0)
    src[~is_t] = torch.randperm(Q, device=cuda, generator=gen) | join.SEP_QUERY_BIT
    pay = torch.randint(-(1 << 31), 1 << 31, (M,), dtype=torch.int32, device=cuda,
                        generator=gen)
    lanes = ((row // 4).to(torch.int32), narrow(src), pay)
    del row, is_t, src
    n_valid = int(0.8 * n_runs)
    want = join._propagate_sep_plain(lanes, n_valid, 1, Q, 32)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=cuda)
    got = _launched("join", lambda: join.propagate_answers_sep(lanes, nv, 1, Q, 32))
    assert torch.equal(got, want)
    assert 0 < int((want != 0).sum()) < Q


@pytest.mark.parametrize("sep", [False, True])
def test_join_staged_repeated_query_ids_raise(cuda, sep):
    """Staged answers (past one 4 MB bucket) whose query ids all repeat one
    id overflow its bucket: the wrapper raises, it drops no answer
    silently."""
    rng = np.random.default_rng(5 + sep)
    n = 1_500_000
    lanes, _n_q = _join_runs(rng, [n], 0.9, kw=1, sep=sep)
    src = lanes[1].numpy().view(np.uint32).copy()
    bit = join.SEP_QUERY_BIT if sep else join.QUERY_BIT
    is_q = (src & np.uint32(bit)) != 0
    src[is_q] = np.uint32(7 | bit)
    lanes = (lanes[0], _i32(src)) + lanes[2:]
    lanes = tuple(x.to(cuda) for x in lanes)
    nv = torch.tensor(n, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="query ids repeat"):
        if sep:
            join.propagate_answers_sep(lanes, nv, 1, int(is_q.sum()), 32)
        else:
            join.propagate_answers(lanes, nv, 1, 6, int(is_q.sum()), 32)


def test_join_reach_past_the_halo_raises(cuda):
    x = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="halo"):
        join.propagate_answers((x, x), 0, 1, 6, 4, max_dup=257)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        sort.merge_sorted_lanes((x,), (x.cpu(),), 1)
    with pytest.raises(TypeError, match="expected torch.int32"):
        sort.merge_sorted_lanes((x.long(),), (x.long(),), 1)
    with pytest.raises(ValueError, match="1-D lane"):
        compact.compact_classes((torch.zeros((8, 2), dtype=torch.int32, device=cuda),), x, 2, (0,))
    with pytest.raises(TypeError, match="compact flags"):
        compact.compact_classes((x,), x.float(), 2, (0,))
    codes = torch.zeros((2, 3), dtype=torch.uint8, device=cuda)
    lens = torch.full((2,), 3, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="ssw kernel launch failed"):  # the best-cell key
        ssw.sw_align_ends(codes, lens, codes, lens, match=1 << 25)
    with pytest.raises(ValueError, match="range cuts kernel takes <= 160 runs"):
        sort.range_select((x,) * 161, [8] * 161, 4)


def _compact_case(rng, n, n_lanes):
    return tuple(_i32(rng.integers(0, 1 << 32, n, dtype=np.uint64)) for _ in range(n_lanes))


def _compact_same(cuda, lanes, flags, n_classes, emit, layouts, fills):
    """compact_lanes with tails filled: every output row is defined, so the
    whole outputs and the counts must equal the plain version's."""
    want, wn = compact.compact_lanes(lanes, flags, n_classes, emit, layouts, fills)
    got, gn = _launched("compact", lambda: compact.compact_lanes(
        tuple(x.to(cuda) for x in lanes), flags.to(cuda), n_classes, emit, layouts, fills))
    assert torch.equal(gn.cpu(), wn)
    for g, w in zip(got, want):
        _same(g, w)
    return wn


@pytest.mark.parametrize("n", [1000 * 4096 + 123, 4096 * 3])
def test_compact_look_back_many_tiles(cuda, n):
    """Over 1,000 look-back tiles (and an exact tile multiple), 3 classes,
    two emitted with fills; a tenth of the flags outside [0, 3) (no class)."""
    rng = np.random.default_rng(n)
    lanes = _compact_case(rng, n, 3)
    fl = rng.integers(0, 3, n).astype(np.int32)
    fl[rng.random(n) < 0.1] = 7
    layouts = (((0,), (1,), (2,)), ((2,), (0,)))
    fills = ((-1, 0, 5), (0x1234, -1))
    wn = _compact_same(cuda, lanes, torch.from_numpy(fl), 3, (2, 0), layouts, fills)
    assert 0 < int(wn.sum()) < n


@pytest.mark.parametrize("frac", [0.0, 1.0, 0.3])
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_compact_keep_mask(cuda, frac, dtype):
    """A bool or uint8 keep mask (nonzero bytes other than 1 too): all rows
    kept, none kept, and a third."""
    rng = np.random.default_rng(int(frac * 10))
    n = 70001
    lanes = _compact_case(rng, n, 2)
    keep = rng.random(n) < frac
    mask = torch.from_numpy(keep) if dtype == torch.bool else torch.from_numpy(
        keep * rng.integers(1, 256, n)).to(torch.uint8)
    wn = _compact_same(cuda, lanes, mask, 2, (0,), (((0,), (1,)),), ((-1, 0),))
    assert int(wn[0]) == int(keep.sum())


def test_compact_four_classes_with_tails(cuda):
    """Four classes, all emitted, each with its own fills: every class's tail
    is counted from the end of its own outputs."""
    rng = np.random.default_rng(4)
    n = 50_001
    lanes = _compact_case(rng, n, 4)
    flags = torch.from_numpy(rng.choice(4, n, p=[0.05, 0.15, 0.3, 0.5]).astype(np.int32))
    layouts = tuple(tuple((i,) for i in range(c + 1)) for c in range(4))
    fills = tuple(tuple(range(10 * c, 10 * c + c + 1)) for c in range(4))
    _compact_same(cuda, lanes, flags, 4, (3, 1, 0, 2), (layouts[3], layouts[1], layouts[0],
                                                       layouts[2]), (fills[3], fills[1],
                                                                     fills[0], fills[2]))


@pytest.mark.parametrize("W", [2, 4, 8])
def test_compact_strided_words(cuda, W):
    """(N, W) row-major words read in place and written as one (N, W) group,
    with constant-0 columns (the finalize layout) and payload lanes."""
    rng = np.random.default_rng(W)
    n = 30_000
    words = torch.from_numpy(rng.integers(0, 1 << 32, (n, W), dtype=np.uint64)
                             .astype(np.uint32).view(np.int32))
    pay = _compact_case(rng, n, 2)
    lanes = tuple(words[:, i] for i in range(W)) + pay
    flags = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32))
    for group in (tuple(range(W)), tuple(range(W - 1)) + (None,)):
        layout = (group, (W,), (W + 1,))
        want, wn = compact.compact_lanes(lanes, flags, 2, (1,), (layout,), ((-1, 0, 0),))
        wd = words.to(cuda)
        got, gn = _launched("compact", lambda: compact.compact_lanes(
            tuple(wd[:, i] for i in range(W)) + tuple(x.to(cuda) for x in pay), flags.to(cuda),
            2, (1,), (layout,), ((-1, 0, 0),)))
        assert got[0][0].shape == (n, W) and got[0][0].is_contiguous()
        assert torch.equal(gn.cpu(), wn)
        _same(got[0], want[0])


def _ssw_pairs(rng, B, Lq, Lr, err=0.05):
    """Queries cut from random refs with substitutions, ragged lengths (0
    included), an all-ambiguous pair and pad bytes."""
    ref = rng.integers(0, 4, (B, Lr)).astype(np.uint8)
    q = np.full((B, Lq), 255, np.uint8)
    off = rng.integers(0, max(Lr - Lq, 0) + 1, B)
    for b in range(B):
        seg = ref[b, off[b] : off[b] + Lq]
        q[b, : seg.size] = seg
    mut = rng.random((B, Lq)) < err
    q[mut] = rng.integers(0, 5, int(mut.sum()))
    ql = rng.integers(0, Lq + 1, B).astype(np.int32)
    rl = rng.integers(0, Lr + 1, B).astype(np.int32)
    ql[:3] = (0, Lq, Lq)
    rl[:3] = (Lr, 0, Lr)
    q[2] = 4  # all ambiguous
    return tuple(map(torch.from_numpy, (q, ql, ref, rl)))


def _ssw_same(cuda, args, scoring):
    want = ssw.sw_align_ends(*args, **scoring)
    got = _launched("ssw", lambda: ssw.sw_align_ends(*(x.to(cuda) for x in args), **scoring))
    _same(got, want)
    return want


@pytest.mark.parametrize("scoring", SCORINGS_ALL)
def test_ssw_ragged(cuda, scoring):
    """B not a multiple of the 128-thread block; q_len or r_len 0; an
    all-ambiguous pair; every scoring, go < ge included."""
    rng = np.random.default_rng(scoring["gap_open"] * 7 + scoring["gap_extend"])
    want = _ssw_same(cuda, _ssw_pairs(rng, 300, 100, 164), scoring)
    assert int((want[0] > 0).sum()) > 200
    assert want[0][:3].tolist() == [0, 0, 0] and want[1][:3].tolist() == [-1, -1, -1]


def test_ssw_ties(cuda):
    """Best scores that tie in several columns (a repeated ref) and in
    several rows of one column (a repeated query base): the first column,
    then the first row."""
    pairs = [("ACGT", "ACGTACGTACGT"), ("AAAA", "A"), ("AAAA", "TTAT"), ("CA", "ACACAC")]
    B = len(pairs)
    q = np.full((B, 4), 255, np.uint8)
    r = np.full((B, 12), 255, np.uint8)
    for i, (a, b) in enumerate(pairs):
        q[i, : len(a)] = ["ACGT".index(c) for c in a]
        r[i, : len(b)] = ["ACGT".index(c) for c in b]
    ql = np.array([len(a) for a, _ in pairs], np.int32)
    rl = np.array([len(b) for _, b in pairs], np.int32)
    args = tuple(map(torch.from_numpy, (q, ql, r, rl)))
    for scoring in SCORINGS_ALL:
        score, qe, re_ = _ssw_same(cuda, args, scoring)
        assert qe.tolist()[:3] == [3, 0, 0] and re_.tolist()[:3] == [3, 0, 2]


@pytest.mark.parametrize("B,Lq,Lr", [(257, 1, 40), (33, 1100, 4200)])
def test_ssw_shapes(cuda, B, Lq, Lr):
    """Lq = 1, and Lq = 1100 with Lr = 4200, past the TPU kernel's limits."""
    rng = np.random.default_rng(Lq)
    _ssw_same(cuda, _ssw_pairs(rng, B, Lq, Lr, err=0.02), SCORINGS_ALL[0])


@pytest.mark.parametrize("a,c", [(1, -1), (1, 0), (1, 1), (2, 1)])
def test_ssw_strip_edges(cuda, a, c):
    """Lr (the strip axis) and Lq at R - 1, R, R + 1 and 2R + 1 for the
    kernel's strip width R, every scoring and one whose scores do not fit
    a signed byte (the compare-and-select substitution)."""
    n = a * SSW_STRIP + c
    rng = np.random.default_rng(n)
    for Lq, Lr in ((n, n), (5, n), (n, 3 * SSW_STRIP + 2)):
        args = _ssw_pairs(rng, 77, Lq, Lr, err=0.1)
        for scoring in SCORINGS_ALL + [SCORING_WIDE]:
            _ssw_same(cuda, args, scoring)


def test_ssw_ties_across_strips(cuda):
    """Equal best scores in two strips, the later strip's on the earlier
    row: the earlier column wins; and inside one strip, the smaller column
    on the later row beats the larger column on the earlier row."""
    R = SSW_STRIP
    pairs = [("CA", "T" * (R - 1) + "ACT"),  # (1, R-1) in strip 0 ties (0, R) in strip 1
             ("GA", "AGT"),                   # (1, 0) ties (0, 1) inside a strip
             ("AC", "T" * (2 * R - 1) + "AC")]  # the best in the last, partial strip
    B = len(pairs)
    Lr = max(len(b) for _, b in pairs)
    q = np.full((B, 2), 255, np.uint8)
    r = np.full((B, Lr), 255, np.uint8)
    for i, (a, b) in enumerate(pairs):
        q[i, : len(a)] = ["ACGT".index(x) for x in a]
        r[i, : len(b)] = ["ACGT".index(x) for x in b]
    ql = np.array([len(a) for a, _ in pairs], np.int32)
    rl = np.array([len(b) for _, b in pairs], np.int32)
    args = tuple(map(torch.from_numpy, (q, ql, r, rl)))
    for scoring in SCORINGS_ALL:
        _score, qe, re_ = _ssw_same(cuda, args, scoring)
        assert qe.tolist()[:2] == [1, 1] and re_.tolist()[:2] == [R - 1, 0]
        assert (qe[2], re_[2]) == (1, 2 * R)


@pytest.mark.parametrize("scoring", SCORINGS_ALL)
def test_ssw_ends_in_the_last_strip(cuda, scoring):
    """Each query is cut from the end of its ref window, so the best cell
    lies in the pair's last strip, which r_len leaves partial at every
    offset."""
    R = SSW_STRIP
    rng = np.random.default_rng(scoring["gap_open"] * 5 + scoring["gap_extend"])
    B, Lq, Lr = 4 * R, 30, 4 * R + 7
    ref = rng.integers(0, 4, (B, Lr)).astype(np.uint8)
    rl = (Lr - np.arange(B) % (2 * R)).astype(np.int32)
    ql = np.full(B, Lq, np.int32)
    q = np.stack([ref[b, rl[b] - Lq : rl[b]] for b in range(B)])
    args = tuple(map(torch.from_numpy, (q, ql, ref, rl)))
    _score, qe, re_ = _ssw_same(cuda, args, scoring)
    assert np.array_equal(re_.numpy(), rl - 1) and (qe.numpy() == Lq - 1).all()


@pytest.mark.parametrize("scores", [(127, 128, 128), (128, 1, 1), (1, 129, 1), (1, 1, 129),
                                    (1, -128, 1)])
def test_ssw_substitution_forms(cuda, scores):
    """Scorings on each side of the kernel's choice of substitution form: a
    byte permute when match, -mismatch and -ambiguity fit a signed byte (the
    first), else compares."""
    match, mismatch, ambiguity = scores
    rng = np.random.default_rng(sum(map(abs, scores)))
    _ssw_same(cuda, _ssw_pairs(rng, 130, 40, 70, err=0.1),
              dict(match=match, mismatch=mismatch, gap_open=3, gap_extend=1, ambiguity=ambiguity))


def test_sw_align_and_cigars(cuda):
    """The full alignment (both passes) and the CIGAR path on CUDA equal the
    CPU's."""
    rng = np.random.default_rng(12)
    args = _ssw_pairs(rng, 200, 120, 184)
    for scoring in SCORINGS_ALL:
        want = ssw.sw_align(*args, **scoring)
        got = ssw.sw_align(*(x.to(cuda) for x in args), **scoring)
        _same(tuple(got.values()), tuple(want.values()))
        cw, mw = ssw.sw_cigar_batch(*args, want, **scoring)
        cg, mg = ssw.sw_cigar_batch(*(x.to(cuda) for x in args), got, **scoring)
        assert cg == cw and np.array_equal(mg, mw)


def test_table_lookup(cuda):
    rng = np.random.default_rng(8)
    T, W = 5000, 2
    keys = rng.integers(0, 1 << 32, (T, W), dtype=np.uint64).astype(np.uint32)
    keys = keys[np.lexsort(tuple(keys[:, w] for w in range(W - 1, -1, -1)))]
    keys[4500:] = 0xFFFFFFFF
    q = np.concatenate([keys[rng.integers(0, T, 3000)],
                        rng.integers(0, 1 << 32, (1000, W), dtype=np.uint64).astype(np.uint32)])
    tw, qw = _i32(keys), _i32(q)
    want = lookup.table_lookup(tw, 4500, qw)
    got = lookup.table_lookup(tw.to(cuda), 4500, qw.to(cuda))
    _same(got, want)


def test_post_asm_block(cuda):
    """A block of reads aligned to contigs on CUDA (index, lookup, vote,
    windows, both passes, CIGARs) equals the CPU."""
    from mhm2_proxy_tpu_torch.models import post_asm

    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), 6000))
    contigs = [genome[:2500], genome[2400:6000], genome[100:140]]
    B, L = 500, 150
    comp = str.maketrans("ACGT", "TGCA")
    codes = np.full((B, L), 4, np.uint8)
    lens = rng.integers(20, L + 1, B).astype(np.int32)
    for b in range(B):
        s = int(rng.integers(0, len(genome) - L))
        read = genome[s : s + lens[b]]
        if b % 2:
            read = read.translate(comp)[::-1]
        codes[b, : lens[b]] = ["ACGT".index(c) for c in read]
    codes[rng.random((B, L)) < 0.01] = 1
    out = {}
    for dev in ("cpu", cuda):
        idx = post_asm.build_contig_index(contigs, 31, device=dev)
        out[str(dev)] = post_asm.align_reads_to_contigs(codes, lens, contigs, index=idx, k=31,
                                                        cigars=True)
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert cpu.keys() == gpu.keys()
    for name in cpu:
        if name == "cigar":
            assert cpu[name] == gpu[name]
        else:
            assert np.array_equal(cpu[name], gpu[name]), name
    assert (cpu["cid"] >= 0).mean() > 0.8


def test_cli_profile_and_restart(cuda, tmp_path):
    """--profile (torch.profiler with CUDA activity) and --restart on the
    card: the trace is written, and the restarted run writes the first
    run's FASTA."""
    import os

    from mhm2_proxy_tpu_torch.io.fastq import write_fastq
    from mhm2_proxy_tpu_torch.main import run_pipeline
    from mhm2_proxy_tpu_torch.options import parse_args
    from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads

    rng = np.random.default_rng(13)
    ids, seqs, quals = simulate_reads(rng, random_genome(rng, 3000), coverage=20.0,
                                      read_len=100, err_rate=0.002)
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, ids, seqs, quals)
    out = str(tmp_path / "run")
    args = ["-r", fq, "-k", "21", "33", "-o", out, "--checkpoint"]
    run_pipeline(parse_args(args + ["--profile"]))
    assert os.path.getsize(f"{out}/profile/trace.json") > 0
    final = open(f"{out}/final_assembly.fasta").read()
    assert final.count(">") >= 1
    os.remove(f"{out}/contigs-33.fasta")
    run_pipeline(parse_args(args + ["--restart"]))
    assert open(f"{out}/final_assembly.fasta").read() == final


@pytest.mark.parametrize("k", [21, 33, 55, 77, 99])
@pytest.mark.parametrize("B,extra", [(3, 0), (5, 1), (7, 127), (2, 129), (3, 2048 - 99)])
def test_minimizer(cuda, k, B, extra):
    """Targets at P = 1, tile edges (128 positions a block), contig windows,
    with N bases; shard counts 1, 2, 3, 4 and 4096."""
    from mhm2_proxy_tpu_torch.constants import minimizer_len_for_k
    from mhm2_proxy_tpu_torch.ops import minimizer

    rng = np.random.default_rng(k * 100 + B + extra)
    m = minimizer_len_for_k(k)
    L = k + extra
    codes = torch.from_numpy(rng.integers(0, 5, (B, L), dtype=np.uint8))
    for S in (1, 2, 3, 4, 4096):
        want = minimizer.minimizer_targets(codes, k, m, S)
        got = _launched("minimizer", lambda: minimizer.minimizer_targets(codes.to(cuda), k, m, S))
        _same((got,), (want,))
    empty = minimizer.minimizer_targets(codes[:0].to(cuda), k, m, 4)
    assert empty.shape == (0, L - k + 1)


@pytest.mark.parametrize("k", [21, 55, 99])
@pytest.mark.parametrize("B,L", [(37, 128), (31, 131), (2, 2049), (3, 4100), (1, 9000)])
def test_minimizer_tiles(cuda, k, B, L):
    """Reads across the kernel's tiles of 2048 bases: B not a multiple of
    a tile's reads (16 at L = 128, 15 at L = 131), and reads past 2048
    bases, a block each, scanned in 2048-candidate chunks."""
    from mhm2_proxy_tpu_torch.constants import minimizer_len_for_k
    from mhm2_proxy_tpu_torch.ops import minimizer

    rng = np.random.default_rng(k + B * 7 + L)
    m = minimizer_len_for_k(k)
    codes = torch.from_numpy(rng.integers(0, 5, (B, L), dtype=np.uint8))
    for S in (3, 64):
        want = minimizer.minimizer_targets(codes, k, m, S)
        got = _launched("minimizer", lambda: minimizer.minimizer_targets(codes.to(cuda), k, m, S))
        _same((got,), (want,))


@pytest.mark.parametrize("k", [21, 33, 77, 99])
@pytest.mark.parametrize("d", [-1, 0, 1])
def test_minimizer_window_segments(cuda, k, d):
    """P a multiple of the window w = k - m + 1, and one off it: the van
    Herk/Gil-Werman segments end at, before and after the last position."""
    from mhm2_proxy_tpu_torch.constants import minimizer_len_for_k
    from mhm2_proxy_tpu_torch.ops import minimizer

    rng = np.random.default_rng(k * 3 + d)
    m = minimizer_len_for_k(k)
    w = k - m + 1
    for P in (w + d, 3 * w + d):
        if P < 1:
            continue
        codes = torch.from_numpy(rng.integers(0, 5, (20, k - 1 + P), dtype=np.uint8))
        want = minimizer.minimizer_targets(codes, k, m, 5)
        got = _launched("minimizer", lambda: minimizer.minimizer_targets(codes.to(cuda), k, m, 5))
        _same((got,), (want,))


def test_cli_shards_2(cuda, tmp_path):
    """--shards 2 on the card writes the FASTA of the same run on the CPU,
    and launches the minimizer kernel."""
    from mhm2_proxy_tpu_torch.io.fastq import write_fastq
    from mhm2_proxy_tpu_torch.main import run_pipeline
    from mhm2_proxy_tpu_torch.options import parse_args
    from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads

    rng = np.random.default_rng(17)
    ids, seqs, quals = simulate_reads(rng, random_genome(rng, 4000), coverage=20.0,
                                      read_len=100, err_rate=0.002)
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, ids, seqs, quals)
    finals = {}
    for dev in ("cpu", "cuda"):
        out = str(tmp_path / dev)
        kernels.reset_launches()
        run_pipeline(parse_args(["-r", fq, "-k", "21", "33", "-o", out, "--shards", "2",
                                 "--block-reads", "1024", "--device", dev]))
        finals[dev] = open(f"{out}/final_assembly.fasta").read()
        assert (kernels.launches()["minimizer"] > 0) == (dev == "cuda")
    assert finals["cuda"] == finals["cpu"] and finals["cuda"].count(">") >= 1


@pytest.mark.parametrize("R,Q", [(2, 2), (7, 17), (33, 9), (40, 64)])
@pytest.mark.parametrize("case", RANGE_CUT_CASES)
def test_range_cuts(cuda, case, R, Q):
    """mhm2_range_cuts against the plain selection: the same cuts and edges
    bit for bit, one launch."""
    seed = R * 131 + Q + RANGE_CUT_CASES.index(case)
    lanes, counts, _ = range_cut_runs(case, np.random.default_rng(seed), R=R, rows=700)
    on_card = range_cut_runs(case, np.random.default_rng(seed), R=R, rows=700, device=cuda)[0]
    counts = [int(n) for n in counts]
    got = _launched("range_cuts", lambda: sort.range_select(on_card, counts, Q))
    _same(got, sort.range_select(lanes, counts, Q))


def test_range_cuts_100m_rows(cuda):
    """100M rows in 12 runs of word 0 of (n, 2) words, every key value and
    heavy duplicates, Q = 17 (the ranged fold's shape at 100M rows: 6M a
    range): the kernel's cuts and edges equal the plain version's, and
    range_cuts reads the counts from the card in one copy."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    runs, counts = [], []
    for j in range(12):
        n = 100_000_000 // 12 + j
        hi = 1 << 32 if j % 3 else 1 << 20
        w = torch.randint(0, hi, (n + 5, 2), dtype=torch.int64, device=cuda, generator=gen)
        w[:n, 0] = torch.sort(w[:n, 0]).values
        w[n:] = 0xFFFFFFFF
        runs.append(((w ^ 0x80000000) - 0x80000000).to(torch.int32)[:, 0])
        counts.append(n)
        del w
    got = _launched("range_cuts", lambda: sort.range_select(runs, counts, 17))
    want = sort.range_select([x.cpu() for x in runs], counts, 17)
    _same(got, want)
    Q, cuts = sort.range_cuts(runs, [torch.tensor(n, device=cuda) for n in counts], 6_000_000)
    assert Q == 17 and cuts == want[0].tolist()


@pytest.mark.parametrize("k", [21, 77])
def test_ranged_store_finalize(cuda, k):
    """A KmerCountStore that collapses every block and folds and applies the
    contig rules by key range: the card's table equals its CPU run's, the
    cuts launched on the card."""
    from mhm2_proxy_tpu_torch.kcount import KmerCountStore

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 8000).astype(np.uint8)

    def windows(n, lo, L, err):
        lens = rng.integers(lo, L + 1, n).astype(np.int32)
        start = rng.integers(0, len(genome) - L, n)
        codes = genome[start[:, None] + np.arange(L)]
        codes = np.where(rng.random(codes.shape) < err, rng.integers(0, 5, codes.shape), codes)
        codes = np.where(np.arange(L) < lens[:, None], codes, 4).astype(np.uint8)
        return codes, lens

    blocks = []
    for _ in range(4):
        codes, lens = windows(100, k + 5, k + 80, 0.01)
        blocks.append((codes, rng.random(codes.shape) > 0.05, lens))
    ctgs = []
    for _ in range(2):
        codes, lens = windows(6, k + 2, 320, 0.0)
        ctgs.append((codes, lens, rng.integers(1, 40, 6).astype(np.int32)))
    tables = {}
    for dev in ("cpu", "cuda"):
        st = KmerCountStore(k, device=dev, raw_budget_bytes=1)
        st.RANGED_FOLD_MIN_ROWS = 0
        st.RANGED_FOLD_TARGET_ROWS = 4096
        for blk in blocks:
            st.add_reads_block(*blk)
        for cb in ctgs:
            st.add_ctgs_block(*cb)
        before = kernels.launches()["range_cuts"]
        tables[dev] = st.finalize().to_numpy()
        assert st.stats["read_pieces"] >= 3 and st.stats["ctg_pieces"] >= 3, st.stats
        assert kernels.launches()["range_cuts"] - before == (2 if dev == "cuda" else 0)
    n = int(tables["cpu"][4])
    assert n > 0 and int(tables["cuda"][4]) == n
    for g, w in zip(tables["cuda"][:4], tables["cpu"][:4]):
        assert np.array_equal(g[:n], w[:n])


@pytest.mark.parametrize("k", [21, 77])
def test_store_round_from_pinned_count_blocks(cuda, k):
    """PackedReads.count_blocks pins its blocks for a card, and a
    KmerCountStore round fed them (their copies do not block) gives the
    table it gives from numpy blocks of the same reads, at the same peak of
    device memory; k = 77 takes the separate-payload path."""
    from mhm2_proxy_tpu_torch.io.reads import PackedReads
    from mhm2_proxy_tpu_torch.kcount import KmerCountStore

    rng = np.random.default_rng(k)
    genome = rng.integers(0, 4, 20000).astype(np.uint8)
    reads = PackedReads()
    for n in (3000, 1700, 2600):
        lens = rng.integers(k // 2, 151, n).astype(np.int32)
        start = rng.integers(0, len(genome) - 150, n)
        codes = genome[start[:, None] + np.arange(150)]
        codes = np.where(rng.random(codes.shape) < 0.01, rng.integers(0, 5, codes.shape), codes)
        reads.add_block(codes.astype(np.uint8), rng.integers(33, 75, codes.shape).astype(np.uint8),
                        lens)
    rows, L, cut = 2048, 160, 53
    pinned = list(reads.count_blocks(rows, L, cut, min_len=k, pin=True))
    assert len(pinned) == 4
    assert all(c.is_pinned() and ok.is_pinned() for c, ok, _ in pinned)
    numpy_blocks = [(c, q >= cut, ln) for c, q, ln in reads.blocks(rows, pad_len=L, min_len=k)]
    tables, peaks = {}, {}
    # the first round on a device allocates the look-back kernels' scratch,
    # which stays: a warm-up round, so that both measured rounds find it
    for name, blocks in (("warm-up", numpy_blocks), ("pinned", pinned), ("numpy", numpy_blocks)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(cuda)
        st = KmerCountStore(k, device=cuda)
        for blk in blocks:
            st.add_reads_block(*blk)
        tables[name] = st.finalize().to_numpy()
        peaks[name] = torch.cuda.max_memory_allocated(cuda)
        del st
    n = int(tables["numpy"][4])
    assert n > 0 and int(tables["pinned"][4]) == n
    for g, w in zip(tables["pinned"][:4], tables["numpy"][:4]):
        assert np.array_equal(g[:n], w[:n])
    assert peaks["pinned"] == peaks["numpy"]
