"""The port's minimizer targets (ops/minimizer.py's plain version of
csrc/minimizer.cu) and its u64 helpers (ops/u64.py, ops/bitkmer.py) against
the JAX package, bit for bit (tolerance 0): the jnp uint64 path, the Pallas
kernel in interpret mode, and the reference oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.ops import bitkmer as rbk
from mhm2_proxy_tpu.ops.count import minimizer_shard_targets as ref_targets
from mhm2_proxy_tpu.ops.count import read_kmer_records as ref_records
from mhm2_proxy_tpu.ops.pallas_minimizer import pallas_minimizer_targets
from mhm2_proxy_tpu.oracle.pyref import target_shard
from mhm2_proxy_tpu_torch.constants import minimizer_len_for_k
from mhm2_proxy_tpu_torch.ops import bitkmer as bk
from mhm2_proxy_tpu_torch.ops import count, u64
from mhm2_proxy_tpu_torch.ops.minimizer import minimizer_targets, remainder_constants
from torch_common import one_torch_thread  # noqa: F401 (autouse fixture)

KS = (21, 33, 55, 77, 99)


def _codes(rng, B, L, n_frac=0.05):
    """Random base codes with N (code 4) at n_frac of the positions."""
    c = rng.integers(0, 4, (B, L), dtype=np.uint8)
    c[rng.random((B, L)) < n_frac] = 4
    return c


@pytest.mark.parametrize("S", [2, 3, 8, 4096])
@pytest.mark.parametrize("k", KS)
def test_targets_equal_reference(k, S):
    rng = np.random.default_rng(k * 31 + S)
    m = minimizer_len_for_k(k)
    for B, L in ((5, k + 37), (3, k)):  # the second has one position a read
        codes = _codes(rng, B, L)
        want = np.asarray(ref_targets(jnp.asarray(codes), k, m, S, use_pallas=False))
        pallas = np.asarray(pallas_minimizer_targets(jnp.asarray(codes), k, m, S, interpret=True))
        got = minimizer_targets(torch.from_numpy(codes), k, m, S)
        assert got.dtype == torch.int32 and got.shape == (B, L - k + 1)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), pallas)


def test_targets_match_the_oracle():
    rng = np.random.default_rng(5)
    for k in KS:
        m = minimizer_len_for_k(k)
        for _ in range(4):
            kmer = "".join(rng.choice(list("ACGT"), size=k))
            codes = bk.ascii_to_codes(kmer.encode())[None, :]
            for S in (2, 7, 64):
                got = int(minimizer_targets(torch.from_numpy(codes), k, m, S)[0, 0])
                assert got == target_shard(kmer, m, S), (k, S, kmer)


@pytest.mark.parametrize("k", KS)
def test_minimizers_from_words_equal_reference(k):
    rng = np.random.default_rng(k)
    m = minimizer_len_for_k(k)
    codes = _codes(rng, 4, k + 20, n_frac=0.0)
    words, _rc = rbk.canonicalize_words(rbk.kmer_words_from_codes(jnp.asarray(codes), k), k)
    words = np.asarray(words).reshape(-1, words.shape[-1])
    want = np.asarray(rbk.minimizers_from_words(jnp.asarray(words), k, m)).view(np.int64)
    got = bk.minimizers_from_words(torch.from_numpy(words.view(np.int32).copy()), k, m)
    np.testing.assert_array_equal(got.numpy(), want)
    # the canonical k-mer's minimizer is the read stream's (strand symmetry)
    from_codes = bk.minimizers_from_codes(torch.from_numpy(codes), k, m).reshape(-1)
    np.testing.assert_array_equal(from_codes.numpy(), want)


def test_quick_hash_u64_edges():
    v = np.array([0, 1 << 63, (1 << 64) - 1, 0x123456789ABCDEF0], np.uint64)
    want = np.asarray(rbk.quick_hash_u64(jnp.asarray(v))).view(np.int64)
    got = bk.quick_hash_u64(torch.from_numpy(v.view(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_u64_helpers_against_python_ints():
    rng = np.random.default_rng(9)
    vals = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1] + [
        int(x) for x in rng.integers(0, 1 << 63, 60, dtype=np.int64)
    ] + [int(x) | (1 << 63) for x in rng.integers(0, 1 << 63, 60, dtype=np.int64)]
    t = torch.tensor([u64.i64(v) for v in vals], dtype=torch.int64)
    back = lambda x: [int(y) & ((1 << 64) - 1) for y in x.tolist()]  # noqa: E731
    for n in (0, 1, 21, 41, 63):
        assert back(u64.shr(t, n)) == [v >> n for v in vals]
    for n in (1, 2, 3, 8, 4096, (1 << 31) - 1):
        assert u64.umod(t, n).tolist() == [v % n for v in vals]
    r = t.flip(0)
    rv = vals[::-1]
    assert back(u64.umax(t, r)) == [max(a, b) for a, b in zip(vals, rv)]
    assert back(u64.umin(t, r)) == [min(a, b) for a, b in zip(vals, rv)]


def test_read_records_target_equals_reference():
    """read_kmer_records' target field, and all zeros with one shard."""
    rng = np.random.default_rng(2)
    k, S = 33, 4
    codes = _codes(rng, 6, 96)
    qual = rng.random(codes.shape) > 0.1
    lens = rng.integers(k - 2, 97, 6).astype(np.int32)
    want = ref_records(jnp.asarray(codes), jnp.asarray(qual), jnp.asarray(lens), k,
                       minimizer_len_for_k(k), n_shards=S, use_pallas=False)["target"]
    got = count.read_kmer_records(torch.from_numpy(codes), torch.from_numpy(qual),
                                  torch.from_numpy(lens), k, n_shards=S)["target"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = count.minimizer_shard_targets(torch.from_numpy(codes), k, minimizer_len_for_k(k), 1)
    assert one.shape == (6, 96 - k + 1) and not one.any()


U32_EDGES = [0, 1, 2, 3, 4095, 4096, 65535, 65536, (1 << 31) - 1, 1 << 31, (1 << 32) - 2,
             (1 << 32) - 1]


def _fastmod(a: int, recip: int, s: int) -> int:
    """csrc/minimizer.cu's fastmod: the high 64 bits of (M a mod 2^64) s."""
    return (((recip * a) & ((1 << 64) - 1)) * s) >> 64


@pytest.mark.parametrize("shards", [range(1, 2049), range(2049, 4097),
                                    [46340, 46341, 65521, 65535]])
def test_remainder_constants_against_python(shards):
    """The kernel's remainders from remainder_constants: every u32's by
    Lemire's direct computation, and a u64 hash's by the fold of its
    halves, equal Python's %, for S = 1..4096 and large S with S^2 < 2^32,
    over edge and random values."""
    rng = np.random.default_rng(len(shards))
    u32 = U32_EDGES + [int(x) for x in rng.integers(0, 1 << 32, 24, dtype=np.uint64)]
    u64s = [0, (1 << 64) - 1, 1 << 63, (1 << 32) - 1, 1 << 32] + [
        int(x) for x in rng.integers(0, 1 << 63, 8, dtype=np.int64)] + [
        int(x) | (1 << 63) for x in rng.integers(0, 1 << 63, 8, dtype=np.int64)]
    for s in shards:
        assert s * s < 1 << 32
        recip, two32 = remainder_constants(s)
        assert 0 <= recip < 1 << 64 and two32 == (1 << 32) % s
        assert [_fastmod(a, recip, s) for a in u32 + [s - 1, s, s + 1, 2 * s - 1]] == [
            a % s for a in u32 + [s - 1, s, s + 1, 2 * s - 1]]
        for h in u64s:
            part = _fastmod(h >> 32, recip, s) * two32 + _fastmod(h & 0xFFFFFFFF, recip, s)
            assert part < 1 << 32 and _fastmod(part, recip, s) == h % s
