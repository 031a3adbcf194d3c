"""Port merge (plain version) vs the JAX reference: the Pallas bitonic merge
in interpret mode and concat + lax.sort."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.ops.pallas_sort import merge_sorted_lanes_padded, merge_sorted_lanes_tiled
from mhm2_proxy_tpu_torch.ops import sort as PS
from torch_common import RANGE_CUT_CASES, range_cut_runs


def _run(rng, n, n_lanes, kw, sent=0, dup_from=None):
    a = rng.integers(0, 1 << 32, (n, n_lanes), dtype=np.uint64).astype(np.uint32)
    a[: n // 3, 0] |= np.uint32(0x80000000)  # bit-31 keys
    a[n // 3 : n // 2, 0] = 0x7FFFFFFF
    if dup_from is not None and n and len(dup_from):
        pick = rng.integers(0, len(dup_from), n // 2)
        a[: n // 2, :kw] = dup_from[pick, :kw]
    if sent:
        a[n - sent :, :kw] = 0xFFFFFFFF
    order = np.lexsort(tuple(a[:, i] for i in range(kw - 1, -1, -1)))
    return a[order]


def _lanes(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i]).view(np.int32)) for i in range(a.shape[1]))


def _np(lanes):
    return np.stack([x.numpy().view(np.uint32) for x in lanes], 1)


@pytest.mark.parametrize("na,nb", [(100, 156), (0, 37), (513, 1), (1000, 3095), (33, 0)])
def test_packed_merge_equals_bitonic_interpret(na, nb):
    rng = np.random.default_rng(na * 7 + nb)
    a = _run(rng, na, 2, 2, sent=na // 10)
    b = _run(rng, nb, 2, 2, sent=nb // 5, dup_from=a)
    got = _np(PS.merge_sorted_lanes(_lanes(a), _lanes(b), 2))
    want = merge_sorted_lanes_padded(tuple(jnp.asarray(a[:, i]) for i in range(2)),
                                     tuple(jnp.asarray(b[:, i]) for i in range(2)), kw=2,
                                     interpret=True)
    assert np.array_equal(got, np.stack([np.asarray(x) for x in want], 1))


@pytest.mark.parametrize("na,nb,kw", [(77, 300, 3), (1001, 999, 4), (5, 0, 1)])
def test_payload_merge_equals_stable_concat_sort(na, nb, kw):
    """With payload lanes the merge is stable (a before b on equal keys):
    it equals the reference's stable concat + lax.sort."""
    rng = np.random.default_rng(na + nb + kw)
    a = _run(rng, na, kw + 2, kw, sent=na // 8)
    b = _run(rng, nb, kw + 2, kw, sent=nb // 8, dup_from=a)
    got = _np(PS.merge_sorted_lanes(_lanes(a), _lanes(b), kw))
    cat = np.concatenate([a, b])
    want = jax.lax.sort(tuple(jnp.asarray(cat[:, i]) for i in range(kw + 2)), num_keys=kw,
                        is_stable=True)
    assert np.array_equal(got, np.stack([np.asarray(x) for x in want], 1))


def _rows_sorted(x):
    return x[np.lexsort(tuple(x[:, i] for i in range(x.shape[1] - 1, -1, -1)))]


def test_tiled_pad_fill():
    """The untiled merge (na + nb rows, no pads) against the first na + nb
    rows of the reference's merge_sorted_lanes_tiled (odd lengths,
    sentinels, bit-31 keys): key lanes equal row for row, and the same rows
    within each key once the reference's pad rows are set aside (the
    bitonic merge orders equal keys its own way, so pads may sit among the
    all-ones sentinels; the join and ctg rules never observe it)."""
    rng = np.random.default_rng(9)
    a = _run(rng, 701, 3, 2, sent=5)
    b = _run(rng, 899, 3, 2, sent=3, dup_from=a)
    got = _np(PS.merge_sorted_lanes(_lanes(a), _lanes(b), 2))
    want = np.stack([np.asarray(x) for x in merge_sorted_lanes_tiled(
        tuple(jnp.asarray(a[:, i]) for i in range(3)), tuple(jnp.asarray(b[:, i]) for i in range(3)),
        kw=2, pad_fill=(0x01FFFFFF,), interpret=True)], 1)
    assert got.shape == (1600, 3) and want.shape == (2048, 3)
    assert np.array_equal(got[:, :2], want[:1600, :2])
    pad = np.array([0xFFFFFFFF, 0xFFFFFFFF, 0x01FFFFFF], np.uint32)
    is_pad = (want == pad).all(1)
    assert is_pad.sum() == 448 and not (got == pad).all(1).any()
    assert np.array_equal(_rows_sorted(got), _rows_sorted(want[~is_pad]))


@pytest.mark.parametrize("na,nb,kw,tile", [(0, 37, 2, 8), (33, 0, 1, 4), (700, 900, 2, 64),
                                           (1000, 3095, 3, 1024), (4096, 4096, 1, 4096)])
def test_merge_path_splits_count(na, nb, kw, tile):
    """The plain version of the sort kernel's partition: at every tile
    boundary, the rows of `a` it reports are the rows of `a` that a stable
    lexsort of the concatenation puts before that boundary (many equal keys
    across the two runs, and all-ones sentinels)."""
    rng = np.random.default_rng(na + nb + tile)
    a = _run(rng, na, kw + 1, kw, sent=na // 10)
    b = _run(rng, nb, kw + 1, kw, sent=nb // 7, dup_from=a)
    got = PS.merge_path_splits(_lanes(a), _lanes(b), kw, tile).numpy()
    cat = np.concatenate([a, b])
    order = np.lexsort(tuple(cat[:, i] for i in range(kw - 1, -1, -1)))  # stable
    from_a = np.concatenate([[0], np.cumsum(order < na)])
    bounds = np.minimum(np.arange(-(-(na + nb) // tile) + 1) * tile, na + nb)
    assert np.array_equal(got, from_a[bounds])


def test_merge_as_words():
    """as_words returns the key lanes as one row-major (N, kw) tensor and
    reads strided key lanes in place: the same rows as the lane tuple."""
    rng = np.random.default_rng(5)
    a = _run(rng, 300, 5, 3, sent=4)
    b = _run(rng, 211, 5, 3, sent=9, dup_from=a)
    wa, wb = torch.from_numpy(a.view(np.int32).copy()), torch.from_numpy(b.view(np.int32).copy())
    words, *pay = PS.merge_sorted_lanes(tuple(wa[:, i] for i in range(5)),
                                        tuple(wb[:, i] for i in range(5)), 3, as_words=True)
    assert words.shape == (511, 3) and words.is_contiguous() and len(pay) == 2
    plain = _np(PS.merge_sorted_lanes(_lanes(a), _lanes(b), 3))
    assert np.array_equal(np.concatenate([_np(tuple(words.T)), _np(pay)], 1), plain)


@pytest.mark.parametrize("target", [1000, 4096, 1 << 20])
@pytest.mark.parametrize("case", RANGE_CUT_CASES)
def test_range_cuts_equal_numpy_order_statistics(case, target):
    """range_cuts (plain version) against numpy over the union of the runs'
    live word 0: Q = max(2, ceil(N / target)) and each run's cuts at
    np.searchsorted(..., "left") of numpy's "lower" order statistics at
    rank floor((N - 1) q / Q), which on these runs are
    np.quantile(method="lower")'s edges too. The ranks are taken in
    integers: np.quantile computes (N - 1) q / Q in float64 and can land
    one rank low where the product is a whole number (N = 579, Q = 17,
    q = 13). Every key's rows fall in one range, and the ranges tile each
    run's live rows."""
    rng = np.random.default_rng(RANGE_CUT_CASES.index(case) * 7 + target)
    lanes, counts, words = range_cut_runs(case, rng)
    Q, cuts = PS.range_cuts(lanes, counts, target)
    union = np.sort(np.concatenate(words))
    N = len(union)
    assert Q == max(2, -(-N // target)) and len(cuts) == len(lanes)
    if N:
        edges = union[(N - 1) * np.arange(1, Q) // Q]
        assert np.array_equal(edges, np.quantile(union, np.arange(1, Q) / Q, method="lower"))
    else:
        edges = np.zeros(Q - 1, np.uint32)
    for w, c in zip(words, cuts):
        assert c == [0, *np.searchsorted(w, edges, "left").tolist(), len(w)]
    # every key in one range: the ranges' key spans, over all runs, are disjoint
    where = {}
    for w, c in zip(words, cuts):
        assert all(a <= b for a, b in zip(c, c[1:]))
        for q in range(Q):
            for key in np.unique(w[c[q]:c[q + 1]]):
                assert where.setdefault(int(key), q) == q
    assert len(where) == len(np.unique(union))
