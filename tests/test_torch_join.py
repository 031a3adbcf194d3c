"""Port join (plain version) vs the JAX reference: propagate_compact in
interpret mode (answers routed back to query order), and the whole
table_join_payload against the reference's merge-join path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.ops import lookup as RL
from mhm2_proxy_tpu.ops import pallas_join as RJ
from mhm2_proxy_tpu_torch.ops import join as PJ
from mhm2_proxy_tpu_torch.ops import lookup as PL
from mhm2_proxy_tpu_torch.ops import sort as PS
from mhm2_proxy_tpu_torch.ops.u32 import lexsort_lanes


def _words(keys):
    return np.stack([(keys >> 10).astype(np.uint32), ((keys & 0x3FF) << 22).astype(np.uint32)], 1)


def _case(rng, T, Q, n_valid, heavy):
    """A table of T sorted unique keys (sentinels past n_valid) and Q
    queries: hits, misses, all-ones rows, and `heavy` keys queried 40 times
    each (equal-key runs longer than the doubling's reach)."""
    keys = np.sort(np.unique(rng.integers(0, 1 << 42, 2 * T, dtype=np.uint64))[:T])
    tw = _words(keys)
    tw[n_valid:] = 0xFFFFFFFF
    hot = keys[rng.integers(0, n_valid, heavy)]
    n_rest = Q - 40 * heavy - Q // 20
    qk = np.concatenate([np.repeat(hot, 40), keys[rng.integers(0, T, n_rest // 2)],
                         rng.integers(0, 1 << 42, n_rest - n_rest // 2, dtype=np.uint64)])
    qw = np.concatenate([_words(qk), np.full((Q // 20, 2), 0xFFFFFFFF, np.uint32)])
    qw = qw[rng.permutation(Q)]
    pay = rng.integers(0, 64, T).astype(np.int64)
    return tw, qw, pay


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _merged(tw, qw, pay, n_out):
    """ops/lookup.py's merged rows, padded to n_out (a multiple of the
    reference kernel's tile) with pad rows the reference's way: all-ones
    keys and source IDX_MASK (query flag clear, idx past any valid row)."""
    T, Q = len(tw), len(qw)
    tsrc = torch.arange(T, dtype=torch.int64) | (torch.from_numpy(pay) << 26)
    qsrc = torch.arange(Q, dtype=torch.int64) | PJ.QUERY_BIT
    a = (_t(tw[:, 0]), _t(tw[:, 1]), tsrc.to(torch.int32))
    b = lexsort_lanes((_t(qw[:, 0]), _t(qw[:, 1]), qsrc.to(torch.int32)), 2)
    merged = PS.merge_sorted_lanes(a, b, 2)
    pads = n_out - (T + Q)
    return tuple(torch.cat([x, torch.full((pads,), f, dtype=torch.int32)])
                 for x, f in zip(merged, (-1, -1, PJ.IDX_MASK)))


@pytest.mark.parametrize("T,Q,n_valid,heavy,max_dup", [
    (6000, 20000, 5900, 6, 32),
    (6000, 20000, 5900, 6, 8),
    (20000, 40000, 19000, 40, 32),  # two reference tiles: runs cross the boundary
])
def test_propagate_equals_reference(T, Q, n_valid, heavy, max_dup):
    rng = np.random.default_rng(T + Q + max_dup)
    tw, qw, pay = _case(rng, T, Q, n_valid, heavy)
    n_out = -(-(T + Q) // RJ.TILE) * RJ.TILE
    merged = _merged(tw, qw, pay, n_out)
    got = PJ.propagate_answers(merged, n_valid, 2, 6, Q, max_dup).numpy().view(np.uint32)

    (dest, ans), cnts = RJ.propagate_compact(
        tuple(jnp.asarray(x.numpy().view(np.uint32)) for x in merged), n_valid, kw=2,
        payload_bits=6, max_dup=max_dup, interpret=True)
    dest, ans, cnts = np.asarray(dest), np.asarray(ans), np.asarray(cnts)
    want = np.full(Q, 0xDEADBEEF, np.uint32)
    for t, c in enumerate(cnts):
        rows = slice(t * RJ.TILE, t * RJ.TILE + int(c))
        want[dest[rows]] = ans[rows]
    assert int(cnts.sum()) == Q
    assert np.array_equal(got, want)
    # the cut-off is real: some hot-key queries lie past the reach and miss
    assert 0 < (got > 0).sum() < Q


def _edge_case(rng, T, n_valid, uu_frac):
    """build_edges' join shape: a table of T sorted unique keys padded with
    all-ones rows past n_valid, and two queries a table row, both all-ones
    where the row is not UU (every pad row too), else a key of the table
    (a hit) or a random key (a miss)."""
    keys = np.sort(np.unique(rng.integers(0, 1 << 42, 2 * T, dtype=np.uint64))[:T])
    tw = _words(keys)
    tw[n_valid:] = 0xFFFFFFFF
    uu = np.zeros(T, bool)
    uu[:n_valid] = rng.random(n_valid) < uu_frac
    qk = np.where(rng.random(2 * T) < 0.7, keys[rng.integers(0, n_valid, 2 * T)],
                  rng.integers(0, 1 << 42, 2 * T, dtype=np.uint64))
    qw = _words(qk)
    qw[~np.concatenate([uu, uu])] = 0xFFFFFFFF
    return tw, qw, rng.integers(0, 64, T).astype(np.int64)


def test_propagate_all_ones_run_past_the_reference_tile():
    """The all-ones run that build_edges makes (the queries of non-UU rows
    and the table's padded rows) longer than the reference kernel's tile:
    no query in it answers, and the rows around it are unchanged."""
    T, n_valid = 24000, 14000
    rng = np.random.default_rng(T)
    tw, qw, pay = _edge_case(rng, T, n_valid, 0.5)
    Q = 2 * T
    n_ones = int((qw == 0xFFFFFFFF).all(1).sum()) + (T - n_valid)
    assert n_ones > RJ.TILE
    n_out = -(-(T + Q) // RJ.TILE) * RJ.TILE
    merged = _merged(tw, qw, pay, n_out)
    got = PJ.propagate_answers(merged, n_valid, 2, 6, Q, 32).numpy().view(np.uint32)

    (dest, ans), cnts = RJ.propagate_compact(
        tuple(jnp.asarray(x.numpy().view(np.uint32)) for x in merged), n_valid, kw=2,
        payload_bits=6, max_dup=32, interpret=True)
    dest, ans, cnts = np.asarray(dest), np.asarray(ans), np.asarray(cnts)
    want = np.full(Q, 0xDEADBEEF, np.uint32)
    for t, c in enumerate(cnts):
        rows = slice(t * RJ.TILE, t * RJ.TILE + int(c))
        want[dest[rows]] = ans[rows]
    assert int(cnts.sum()) == Q
    assert np.array_equal(got, want)
    ones = (qw == 0xFFFFFFFF).all(1)
    assert not got[ones].any() and got[~ones].any()


@pytest.mark.parametrize("T,Q", [(6000, 20000), (9000, 30000)])
def test_table_join_payload_equals_reference(T, Q, monkeypatch):
    rng = np.random.default_rng(T)
    tw, qw, pay = _case(rng, T, Q, T - 77, heavy=0)
    monkeypatch.setattr(RL, "_USE_MERGE_JOIN", True)
    i0, f0, p0 = RL.table_join_payload(jnp.asarray(tw), jnp.int32(T - 77), jnp.asarray(qw),
                                       jnp.asarray(pay.astype(np.uint32)), payload_bits=6)
    i1, f1, p1 = PL.table_join_payload(_t(tw), torch.tensor(T - 77, dtype=torch.int32), _t(qw),
                                       torch.from_numpy(pay), payload_bits=6)
    assert np.array_equal(f1.numpy(), np.asarray(f0)) and f1.any() and not f1.all()
    assert np.array_equal(i1.numpy(), np.asarray(i0))
    assert np.array_equal(p1.numpy().view(np.uint32), np.asarray(p0))


@pytest.mark.parametrize("T,Q,payload_bits,limit", [
    (512, 3000, 6, 64),      # past the (patched) fused row limit: the arctic k=21 shape's path
    (6000, 20000, 6, 8192),  # queries past the limit, table below it
    (3000, 9000, 32, None),  # a payload too wide for the fused lane
])
def test_separate_lane_join_equals_reference(T, Q, payload_bits, limit, monkeypatch):
    """The separate-lane join (max(T, Q) >= _FUSED_MAX_ROWS, or a wide
    payload) against the reference's XLA branch, with _FUSED_MAX_ROWS
    shrunk in both packages as tests/test_lookup.py:140-170 does."""
    if limit is not None:
        monkeypatch.setattr(RL, "_FUSED_MAX_ROWS", limit)
        monkeypatch.setattr(PL, "_FUSED_MAX_ROWS", limit)
    rng = np.random.default_rng(T + Q + payload_bits)
    tw, qw, _ = _case(rng, T, Q, T - 30, heavy=0)
    pay = rng.integers(0, 1 << payload_bits, T, dtype=np.uint64)
    i0, f0, p0 = RL.table_join_payload.__wrapped__(
        jnp.asarray(tw), jnp.int32(T - 30), jnp.asarray(qw), jnp.asarray(pay.astype(np.uint32)),
        max_dup=32, payload_bits=payload_bits)
    i1, f1, p1 = PL.table_join_payload(_t(tw), torch.tensor(T - 30, dtype=torch.int32), _t(qw),
                                       torch.from_numpy(pay.astype(np.int64)),
                                       payload_bits=payload_bits)
    assert np.array_equal(f1.numpy(), np.asarray(f0)) and f1.any() and not f1.all()
    assert np.array_equal(i1.numpy(), np.asarray(i0))
    assert np.array_equal(p1.numpy().view(np.uint32), np.asarray(p0))
