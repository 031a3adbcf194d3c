"""Port finalize (plain versions of the finalize and compact kernels) vs the
JAX reference's final_from_sorted_packed (XLA branch), purge True and False."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.constants import words32_for_k
from mhm2_proxy_tpu.ops import count as RC
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
