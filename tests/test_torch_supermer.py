"""The port's supermer records (ops/supermer.py) against the JAX package's
build_supermers and expand_supermers, bit for bit (tolerance 0): the records
of every valid (segment-start) row, their targets, the valid rows and the
k-mer count, at k = 21, 33 and 77, on reads with N bases, low-quality dips,
runs longer than SMAX, reads shorter than k + 2, and the contig-depth form;
and the unpacked windows of those records."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.ops.supermer import build_supermers as ref_build
from mhm2_proxy_tpu.ops.supermer import expand_supermers as ref_expand
from mhm2_proxy_tpu_torch.constants import minimizer_len_for_k
from mhm2_proxy_tpu_torch.ops.supermer import (SMAX, build_supermers, expand_supermers,
                                               record_kmers, supermer_layout)
from torch_common import one_torch_thread  # noqa: F401 (autouse fixture)


def _block(rng, B, L, k):
    """Reads of random lengths (some shorter than k + 2) over a small genome
    (so runs repeat), with N bases and low-quality dips."""
    genome = rng.integers(0, 4, 600).astype(np.uint8)
    codes = np.full((B, L), 4, np.uint8)
    lens = rng.integers(k - 2, L + 1, B).astype(np.int32)
    lens[:3] = (k, k + 1, k + 2)
    for i in range(B):
        s = rng.integers(0, genome.size - L)
        codes[i, : lens[i]] = genome[s : s + lens[i]]
    codes[(rng.random((B, L)) < 0.01)] = 4
    qual_ok = rng.random((B, L)) > 0.03
    return codes, qual_ok, lens


CASES = {
    # name: (k, n_shards, n_src, contig depth)
    "k21_s4": (21, 4, 1, False),
    "k21_one_shard_long_runs": (21, 1, 1, False),
    "k33_s8_two_sources": (33, 8, 2, False),
    "k77_s2": (77, 2, 1, False),
    "k33_s3_contig_depth": (33, 3, 2, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_and_expand_equal_reference(case):
    k, S, n_src, ctg = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + k)
    B, L = 24, 160 if k > 64 else 96
    codes, qual_ok, lens = _block(rng, B * n_src, L, k)
    depth = rng.integers(0, 70000, B * n_src).astype(np.int32) if ctg else None
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = build_supermers(t(codes), t(qual_ok), t(lens), k, SMAX, S,
                          depth=None if depth is None else t(depth), n_src=n_src)
    nb, cw, mw, R = supermer_layout(k, SMAX)
    assert got["records"].shape[2] == R
    n_kmers = 0
    longest = 0
    for s in range(n_src):
        rows = slice(s * B, (s + 1) * B)
        want = ref_build(jnp.asarray(codes[rows]), jnp.asarray(qual_ok[rows]),
                         jnp.asarray(lens[rows]), k, minimizer_len_for_k(k), SMAX, S,
                         depth=None if depth is None else jnp.asarray(depth[rows]))
        wv = np.asarray(want["valid"])
        v = got["valid"][s].numpy()
        assert v.sum() == wv.sum() > 0
        assert not v[v.sum():].any()  # the source's records first, then padding
        np.testing.assert_array_equal(got["row"][s, : v.sum()].numpy(), np.nonzero(wv)[0])
        recs = got["records"][s, : v.sum()].numpy().view(np.uint32)
        np.testing.assert_array_equal(recs, np.asarray(want["records"])[wv])
        np.testing.assert_array_equal(got["target"][s, : v.sum()].numpy(),
                                      np.asarray(want["target"])[wv])
        n_kmers += int(want["n_kmers"])
        # the unpacked windows of the same records
        wexp = ref_expand(jnp.asarray(recs), k, SMAX)
        gexp = expand_supermers(torch.from_numpy(recs.view(np.int32).copy()), k, SMAX)
        for g, w in zip(gexp, wexp):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        n = record_kmers(torch.from_numpy(recs.view(np.int32).copy()), k, SMAX)
        assert int(n.sum()) == int(np.asarray(want["n_kmers"]))
        longest = max(longest, int(n.max()))
    assert got["n_kmers"] == n_kmers
    if S == 1:  # one shard: every read's run is longer than SMAX and splits
        assert longest == SMAX


def test_expand_empty_and_host_bits():
    """An empty record expands to lens 0; the spare top byte of the meta word
    (where the two-stage exchange keeps the target host) changes neither
    n nor the depth."""
    k = 21
    nb, cw, mw, R = supermer_layout(k, SMAX)
    rng = np.random.default_rng(3)
    recs = rng.integers(0, 2**32, (6, R), dtype=np.uint64).astype(np.uint32)
    recs[:, cw + mw] = (recs[:, cw + mw] & 0xFFFFFF00) | np.array([0, 1, 5, 24, 0, 3], np.uint32)
    recs[:, cw + mw] |= np.uint32(0xFF) << 24
    wexp = ref_expand(jnp.asarray(recs), k, SMAX)
    gexp = expand_supermers(torch.from_numpy(recs.view(np.int32).copy()), k, SMAX)
    for g, w in zip(gexp, wexp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert gexp[2].tolist() == [0, k + 2, k + 6, k + 25, 0, k + 4]
