"""Port merge (plain version) vs the JAX reference: the Pallas bitonic merge
in interpret mode and concat + lax.sort."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.ops.pallas_sort import merge_sorted_lanes_padded, merge_sorted_lanes_tiled
from mhm2_proxy_tpu_torch.ops import sort as PS


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
    """Against the reference's merge_sorted_lanes_tiled (odd lengths,
    sentinels, bit-31 keys): the same length, key lanes equal row for row,
    and the same rows within each key (the bitonic merge orders equal keys
    its own way; the join and ctg rules never observe it)."""
    rng = np.random.default_rng(9)
    a = _run(rng, 701, 3, 2, sent=5)
    b = _run(rng, 899, 3, 2, sent=3, dup_from=a)
    got = _np(PS.merge_sorted_lanes_tiled(_lanes(a), _lanes(b), 2, pad_fill=(0x01FFFFFF,)))
    want = np.stack([np.asarray(x) for x in merge_sorted_lanes_tiled(
        tuple(jnp.asarray(a[:, i]) for i in range(3)), tuple(jnp.asarray(b[:, i]) for i in range(3)),
        kw=2, pad_fill=(0x01FFFFFF,), interpret=True)], 1)
    assert got.shape == want.shape == (2048, 3) and got.shape[0] % PS.TILE == 0
    assert np.array_equal(got[:, :2], want[:, :2])
    assert np.array_equal(_rows_sorted(got), _rows_sorted(want))
    plain = _np(PS.merge_sorted_lanes(_lanes(a), _lanes(b), 2))
    assert np.array_equal(got[:1600], plain)
    assert (got[1600:, :2] == 0xFFFFFFFF).all() and (got[1600:, 2] == 0x01FFFFFF).all()
