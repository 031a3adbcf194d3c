"""table_join and rank_rows (mhm2_proxy_tpu_torch/ops/lookup.py) against the
JAX reference's on the CPU: 1-3 key words, words at and above 2^31,
duplicate keys, a valid prefix with an all-ones tail, all-ones queries and
an empty query set (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.ops import lookup as R
from mhm2_proxy_tpu_torch.ops import lookup as P

T, N_VALID = 300, 260


def _table(rng, W, unique):
    """(T, W) uint32 rows sorted in u32 order over the first N_VALID rows,
    all-ones after; the first word straddles 2^31, keys repeat unless
    `unique`."""
    keys = rng.integers(0, 1 << 32, (N_VALID, W), dtype=np.uint64).astype(np.uint32)
    keys[:, 0] = rng.integers((1 << 31) - 6, (1 << 31) + 6, N_VALID).astype(np.uint32)
    if W > 1:
        keys[:, -1] &= np.uint32(0x8000000F)  # few low-word values: equal rows
    if not unique:
        keys[1::7] = keys[0::7][: len(keys[1::7])]
    keys = np.unique(keys, axis=0) if unique else keys
    keys = keys[np.lexsort(keys.T[::-1])]
    table = np.full((T, W), 0xFFFFFFFF, np.uint32)
    table[: len(keys)] = keys
    return table, len(keys)


def _queries(rng, table, n_valid, Q):
    W = table.shape[1]
    if Q == 0:
        return np.zeros((0, W), np.uint32)
    hit = table[rng.integers(0, n_valid, Q // 2)]
    near = table[rng.integers(0, n_valid, Q // 4)].copy()
    near[:, -1] ^= np.uint32(1)
    rand = rng.integers(0, 1 << 32, (Q - len(hit) - len(near) - 4, W),
                        dtype=np.uint64).astype(np.uint32)
    ones = np.full((4, W), 0xFFFFFFFF, np.uint32)
    return np.concatenate([hit, near, rand, ones])


def _t(words):
    return torch.from_numpy(words.view(np.int32).copy())


@pytest.mark.parametrize("Q", [0, 200])
@pytest.mark.parametrize("W", [1, 2, 3])
def test_table_join_equals_reference(W, Q):
    rng = np.random.default_rng(10 * W + Q)
    table, n_valid = _table(rng, W, unique=True)
    qw = _queries(rng, table, n_valid, Q)
    qw[5:9] = qw[:1]  # repeated queries (none when Q is 0)
    want_idx, want_found = (np.asarray(x) for x in R.table_join(jnp.asarray(table), n_valid,
                                                                 jnp.asarray(qw)))
    idx, found = P.table_join(_t(table), n_valid, _t(qw))
    assert idx.dtype == torch.int32 and found.dtype == torch.bool and found.shape == (Q,)
    np.testing.assert_array_equal(found.numpy(), want_found)
    np.testing.assert_array_equal(idx.numpy()[want_found], want_idx[want_found])
    if Q:
        assert want_found[: Q // 2].all() and not want_found[-4:].any()
        np.testing.assert_array_equal(table[idx.numpy()[want_found]], qw[want_found])


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("W", [1, 2, 3])
def test_rank_rows_equals_reference(W, upper):
    rng = np.random.default_rng(W + 7 * upper)
    table, n_valid = _table(rng, W, unique=False)
    qw = _queries(rng, table, n_valid, 240)
    want = np.asarray(R.rank_rows(jnp.asarray(table), n_valid, jnp.asarray(qw), upper=upper))
    got = P.rank_rows(_t(table), n_valid, _t(qw), upper=upper)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the rank counts the valid prefix only, in u32 order
    rows = [tuple(r) for r in table[:n_valid]]
    brute = [sum((r <= tuple(q)) if upper else (r < tuple(q)) for r in rows) for q in qw]
    np.testing.assert_array_equal(got.numpy(), brute)
    assert (got.numpy()[-4:] == n_valid).all()


@pytest.mark.parametrize("upper", [False, True])
def test_rank_rows_empty_queries_and_table(upper):
    table, n_valid = _table(np.random.default_rng(3), 2, unique=False)
    got = P.rank_rows(_t(table), n_valid, _t(np.zeros((0, 2), np.uint32)), upper=upper)
    assert got.shape == (0,) and got.dtype == torch.int32
    q = np.array([[0, 0], [0xFFFFFFFF, 0xFFFFFFFF]], np.uint32)
    got = P.rank_rows(_t(np.zeros((0, 2), np.uint32)), 0, _t(q), upper=upper)
    assert got.tolist() == [0, 0]
