"""Port scan (plain versions) vs the JAX reference's Pallas scan kernels in
interpret mode, as tests/test_pallas_scan.py runs them: integer-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.constants import MAX_KMER_COUNT
from mhm2_proxy_tpu.ops import pallas_scan as RS
from mhm2_proxy_tpu_torch.ops import scan as PS
from torch_common import one_torch_thread  # noqa: F401 (autouse fixture)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _ref_lanes(pays, is_start):
    """The reference kernel over a TILE multiple: pad rows pay 0, start True
    (ops/count.py:227-237 pads the same way)."""
    N = len(is_start)
    pad = -(-N // RS.TILE) * RS.TILE - N
    pays = [np.concatenate([p, np.zeros(pad, np.int32)]) for p in pays]
    st = np.concatenate([is_start, np.ones(pad, bool)])
    out = RS.group_sums_scan_lanes(tuple(jnp.asarray(p) for p in pays), jnp.asarray(st),
                                   clamp=MAX_KMER_COUNT, interpret=True)
    return [np.asarray(x)[:N] for x in out]


@pytest.mark.parametrize("p_start", [0.001, 0.3, 0.9, 1.0])
@pytest.mark.parametrize("N", [RS.TILE * 2, RS.TILE + 4099])
def test_scan_lanes_equals_reference(p_start, N):
    rng = np.random.default_rng(int(p_start * 1000) + N)
    is_start = rng.random(N) < p_start
    # at p_start 0.001 the first rows precede any start: their group runs from row 0
    is_start[0] = p_start > 0.001
    pays = [rng.integers(0, 7, N).astype(np.int32) for _ in range(9)]
    want = _ref_lanes(pays, is_start)
    got = PS.group_sums_scan_lanes(tuple(torch.from_numpy(p) for p in pays),
                                   torch.from_numpy(is_start), MAX_KMER_COUNT)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_scan_lanes_one_group_past_the_clamp():
    """One group across every tile, past the u16 clamp (2 * TILE rows of 3
    and of 1000; the reference sums exactly in int32, so its group sums
    stay below 2^31)."""
    N = RS.TILE * 2
    is_start = np.zeros(N, bool)
    is_start[0] = True
    pays = [np.full(N, 3, np.int32), np.full(N, 1000, np.int32)] + [np.zeros(N, np.int32)] * 7
    want = _ref_lanes(pays, is_start)
    got = PS.group_sums_scan_lanes(tuple(torch.from_numpy(p) for p in pays),
                                   torch.from_numpy(is_start), MAX_KMER_COUNT)
    assert np.array_equal(want[0], np.minimum(np.arange(1, N + 1) * 3, MAX_KMER_COUNT))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("start_every", [0, 50_000])
def test_scan_lanes_groups_across_tiles_past_0xffff(start_every):
    """Groups across several reference tiles (one group over all six, or
    starts every 50,000 rows, off the tile edges) with lane values past
    0xFFFF on a few rows: the CUDA kernel's 16-bit form clamps each input at
    0xFFFF before its saturating adds, which must equal the reference's
    clamp of the exact sum (the sums stay below 2^31, where the reference
    is exact)."""
    N = RS.TILE * 6
    rng = np.random.default_rng(N + start_every)
    is_start = np.zeros(N, bool)
    is_start[0] = True
    if start_every:
        is_start[::start_every] = True
    pays = []
    for _ in range(9):
        p = rng.integers(0, 4, N).astype(np.int32)
        big = rng.random(N) < 0.002
        p[big] = rng.integers(0x10000, 1 << 20, int(big.sum()))
        pays.append(p)
    want = _ref_lanes(pays, is_start)
    got = PS.group_sums_scan_lanes(tuple(torch.from_numpy(p) for p in pays),
                                   torch.from_numpy(is_start), MAX_KMER_COUNT)
    assert (want[0] == MAX_KMER_COUNT).any() and (want[0] < MAX_KMER_COUNT).any()
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def _packed_run(rng, k, N, n_keys, n_sent):
    weff = -(-2 * k // 32)
    free = 32 * weff - 2 * k
    keymask = 0xFFFFFFFF ^ ((1 << free) - 1)
    keys = rng.integers(0, 1 << 32, (n_keys, weff), dtype=np.uint64).astype(np.uint32)
    keys[: n_keys // 2, 0] |= np.uint32(0x80000000)
    keys[:, -1] &= np.uint32(keymask)
    rows = keys[rng.integers(0, n_keys, N - n_sent)]
    pay = 1 | (rng.integers(0, 6, N - n_sent) << 1) | (rng.integers(0, 6, N - n_sent) << 4)
    rows[:, -1] |= pay.astype(np.uint32)
    rows = np.concatenate([rows, np.full((n_sent, weff), 0xFFFFFFFF, np.uint32)])
    order = np.lexsort(tuple(rows[:, i] for i in reversed(range(weff))))
    return rows[order], keymask


@pytest.mark.parametrize("k,n_keys,n_sent,tiles", [
    (21, 97, 700, 2),       # few keys: groups across tiles
    (33, 40000, 3, 2),
    (55, 1, 10000, 3),      # one group past the clamp, long sentinel tail
    (99, 1000, 1, 2),
])
def test_scan_packed_equals_reference(k, n_keys, n_sent, tiles):
    rng = np.random.default_rng(k + n_keys)
    N = tiles * RS.TILE
    rows, keymask = _packed_run(rng, k, N, n_keys, n_sent)
    lanes = tuple(rows[:, i] for i in range(rows.shape[1]))
    want = RS.group_sums_scan_packed(tuple(jnp.asarray(x) for x in lanes), keymask,
                                     MAX_KMER_COUNT, interpret=True)
    got = PS.group_sums_scan_packed(tuple(_t(x) for x in lanes), keymask, MAX_KMER_COUNT)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))
    if n_keys == 1:
        assert (np.asarray(want[0]) == MAX_KMER_COUNT).any()


def test_scan_empty():
    empty = torch.zeros((0,), dtype=torch.int32)
    assert all(x.shape == (0,) for x in PS.group_sums_scan_lanes(
        (empty,) * 9, torch.zeros((0,), dtype=torch.bool), MAX_KMER_COUNT))
    assert all(x.shape == (0,) for x in PS.group_sums_scan_packed(
        (empty, empty), 0xFFFFFC00, MAX_KMER_COUNT))
