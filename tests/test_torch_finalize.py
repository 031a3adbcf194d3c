"""Port finalize (the plain version of the fused finalize kernel,
scan_purge_compact) vs the JAX reference: its final_from_sorted_packed (XLA
branch), and its Pallas scan_purge_compact followed by ragged_append, both
in interpret mode, purge True and False. Tolerance 0 (integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.constants import words32_for_k
from mhm2_proxy_tpu.ops import count as RC
from mhm2_proxy_tpu.ops.pallas_compact import ragged_append
from mhm2_proxy_tpu.ops.pallas_finalize import TILE
from mhm2_proxy_tpu.ops.pallas_finalize import scan_purge_compact as ref_scan_purge_compact
from mhm2_proxy_tpu_torch.ops import count as PC
from mhm2_proxy_tpu_torch.ops import finalize as PF


def _reads_block(rng, k, B=48, glen=300):
    L = max(96, k + 40)
    genome = rng.integers(0, 4, glen).astype(np.uint8)
    codes = np.full((B, L), 4, np.uint8)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        ln = int(rng.integers(k - 1, L + 1))
        s = int(rng.integers(0, glen - ln))
        codes[i, :ln] = genome[s : s + ln]
        lens[i] = ln
    err = rng.random(codes.shape) < 0.01
    codes = np.where(err, rng.integers(0, 5, codes.shape), codes).astype(np.uint8)
    return codes, rng.random(codes.shape) > 0.08, lens


def _merged_run(k, seed):
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(3):
        codes, q, lens = _reads_block(rng, k)
        runs.append(RC.block_to_raw_run(jnp.asarray(codes), jnp.asarray(q), jnp.asarray(lens), k))
    return RC.merge_raw_runs(runs)


@pytest.mark.parametrize("k", [21, 33, 99])
@pytest.mark.parametrize("purge", [True, False])
def test_final_from_sorted_packed_equals_reference(k, purge):
    merged = _merged_run(k, k)
    W = words32_for_k(k)
    want = RC.final_from_sorted_packed(tuple(merged), k, W, dmin_thres=2, purge=purge)
    lanes = tuple(torch.from_numpy(np.array(x).view(np.int32)) for x in merged)
    got = PC.final_from_sorted_packed(lanes, k, W, dmin_thres=2, purge=purge)
    assert int(got[-1]) == int(want[-1]) > 0
    for g, w in zip(got[:-1], want[:-1]):
        g = g.numpy()
        w = np.asarray(w)
        if g.dtype == np.int32 and w.dtype == np.uint32:
            g = g.view(np.uint32)
        assert g.shape == w.shape and np.array_equal(g, w)


def test_ext_calls_match_reference():
    rng = np.random.default_rng(2)
    c4 = rng.integers(0, 40, (4000, 4)).astype(np.int32)
    c4[:500] = rng.integers(0, 3, (500, 4))
    c4[500:600] = 7  # four-way ties
    count = c4.sum(1) + rng.integers(0, 30, 4000).astype(np.int32)
    count[:50] = 65535
    for dmin in (2, 3):
        want = np.asarray(RC._get_ext_calls(jnp.asarray(c4), jnp.asarray(count), dmin))
        got = PF.get_ext_calls(torch.from_numpy(c4), torch.from_numpy(count), dmin).numpy()
        assert np.array_equal(got, want)


def _sorted_run(rng, k, n, sep):
    """A sorted raw run of n rows: groups of 1-6 rows (random keys), one of
    them 300 rows long across row TILE, the read payload's ext codes 0-5,
    then a sentinel tail of n // 20 rows. Packed (uint32 lanes, the 7-bit
    payload in the last lane's free bits) or, with sep, weff key lanes and
    a count-1 payload lane."""
    weff = -(-2 * k // 32)
    free = 32 * weff - 2 * k
    n_live = n - n // 20
    sizes = rng.integers(1, 7, n_live)
    idx = np.repeat(np.arange(n_live), sizes)[:n_live]
    if n_live > TILE + 150:
        idx[TILE - 150 : TILE + 150] = idx[TILE - 150]
        idx[TILE + 150 :] += idx[TILE - 150] - idx[TILE + 150] + 1
    n_keys = int(idx[-1]) + 1
    keys = rng.integers(0, 1 << 32, (n_keys + 64, weff), dtype=np.uint64).astype(np.uint32)
    if not sep:
        keys[:, -1] &= np.uint32((0xFFFFFFFF >> free) << free)
    keys = np.unique(keys, axis=0)
    keys = keys[(keys != 0xFFFFFFFF).any(1)][:n_keys]
    rows = np.full((n, weff), 0xFFFFFFFF, np.uint32)
    rows[:n_live] = keys[idx]
    left, right = rng.integers(0, 6, n_live), rng.integers(0, 6, n_live)
    if sep:
        pay = np.zeros(n, np.uint32)
        pay[:n_live] = 1 | (left << 16) | (right << 24)
        return [rows[:, i].copy() for i in range(weff)], pay
    rows[:n_live, -1] |= (1 | (left << 1) | (right << 4)).astype(np.uint32)
    return [rows[:, i].copy() for i in range(weff)], None


def _reference(keys, pay, k, purge):
    """The JAX package's fused kernel over the run padded to whole tiles,
    then ragged_append: (its compacted lanes, the kept count)."""
    n = keys[0].shape[0]
    pad = -n % TILE
    lanes = tuple(jnp.asarray(np.concatenate([x, np.full(pad, 0xFFFFFFFF, np.uint32)]))
                  for x in keys)
    ref_pay = None if pay is None else jnp.asarray(np.concatenate([pay, np.zeros(pad, np.uint32)]))
    comp, cnts = ref_scan_purge_compact(lanes, k, dmin_thres=2, purge=purge, interpret=True,
                                        pay=ref_pay)
    off = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(cnts)]).astype(jnp.int32)
    out = ragged_append(comp, jnp.zeros_like(cnts), off, interpret=True)
    return [np.asarray(x) for x in out], int(off[-1])


@pytest.mark.parametrize("k,sep,n", [(21, False, 2 * TILE - 777), (33, False, TILE),
                                     (99, False, TILE - 5), (63, True, TILE),
                                     (77, True, 2 * TILE - 3)])
@pytest.mark.parametrize("purge", [True, False])
def test_scan_purge_compact_equals_pallas(k, sep, n, purge):
    """scan_purge_compact's plain version (the fused kernel's function) ==
    the JAX package's scan_purge_compact + ragged_append, in interpret mode:
    the kept rows' keys and payload lanes and their count; past the count
    the port's words are all-ones and its payload lanes 0."""
    rng = np.random.default_rng(k * 10 + purge + n)
    keys, pay = _sorted_run(rng, k, n, sep)
    want, n_want = _reference(keys, pay, k, purge)
    weff, W = len(keys), words32_for_k(k)
    to_t = lambda x: torch.from_numpy(x.view(np.int32))  # noqa: E731
    words, *pays, n_kept = PF.scan_purge_compact(
        tuple(to_t(x) for x in keys), k, W, dmin_thres=2, purge=purge,
        pay=None if pay is None else to_t(pay))
    assert int(n_kept) == n_want > 0
    assert words.shape == (n, W) and len(pays) == (1 if purge else 5)
    words = words.numpy().view(np.uint32)
    np.testing.assert_array_equal(words[:n_want, :weff], np.stack(want[:weff], 1)[:n_want])
    assert (words[:n_want, weff:] == 0).all() and (words[n_want:] == 0xFFFFFFFF).all()
    for got, ref in zip(pays, want[weff:]):
        got = got.numpy().view(np.uint32)
        np.testing.assert_array_equal(got[:n_want], ref[:n_want])
        assert (got[n_want:] == 0).all()
