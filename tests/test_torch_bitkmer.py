"""Port bitkmer (torch, int32 storage) vs the JAX reference, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.ops import bitkmer as R
from mhm2_proxy_tpu_torch.ops import bitkmer as P


def _i32(a):
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("k", [21, 33, 55, 99])
def test_words_revcomp_canonical(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 5, (6, k + 40), dtype=np.uint8)
    want = np.asarray(R.kmer_words_from_codes(jnp.asarray(codes), k))
    got = P.kmer_words_from_codes(torch.from_numpy(codes), k)
    assert np.array_equal(_u32(got), want)
    w = want.reshape(-1, want.shape[-1])
    assert np.array_equal(_u32(P.revcomp_words(_i32(w), k)),
                          np.asarray(R.revcomp_words(jnp.asarray(w), k)))
    cw, rc = P.canonicalize_words(_i32(w), k)
    cw_r, rc_r = R.canonicalize_words(jnp.asarray(w), k)
    assert np.array_equal(_u32(cw), np.asarray(cw_r))
    assert np.array_equal(rc.numpy(), np.asarray(rc_r))


@pytest.mark.parametrize("k", [21, 33, 99])
def test_graph_steps_and_decode(k):
    rng = np.random.default_rng(100 + k)
    codes = rng.integers(0, 4, (40, k), dtype=np.uint8)
    w = np.asarray(R.kmer_words_from_codes(jnp.asarray(codes), k))[:, 0, :]
    base = rng.integers(0, 4, 40).astype(np.uint8)
    assert np.array_equal(
        _u32(P.forward_base_words(_i32(w), torch.from_numpy(base), k)),
        np.asarray(R.forward_base_words(jnp.asarray(w), jnp.asarray(base), k)))
    assert np.array_equal(
        _u32(P.backward_base_words(_i32(w), torch.from_numpy(base), k)),
        np.asarray(R.backward_base_words(jnp.asarray(w), jnp.asarray(base), k)))
    assert np.array_equal(P.first_base(_i32(w)).numpy(), np.asarray(R.first_base(jnp.asarray(w))))
    assert np.array_equal(P.last_base(_i32(w), k).numpy(), np.asarray(R.last_base(jnp.asarray(w), k)))
    assert np.array_equal(P.decode_words_ascii(w, k), R.decode_words_ascii(w, k))
    assert np.array_equal(P.decode_words_ascii(w.view(np.int32), k), R.decode_words_ascii(w, k))
    assert P.words_to_strings(w, k) == R.words_to_strings(w, k)
    assert np.array_equal(P.ascii_to_codes(b"ACGTNacgtnX"), R.ascii_to_codes(b"ACGTNacgtnX"))


def test_unsigned_lexsort_order():
    """All-ones sorts last and bit-31 keys sort above the rest (the order
    int32 storage must not break)."""
    from mhm2_proxy_tpu_torch.ops.u32 import lexsort_lanes

    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 32, (500, 3), dtype=np.uint64).astype(np.uint32)
    a[::7, 0] = 0x80000000
    a[::11] = 0xFFFFFFFF
    a[::13, :2] = a[0, :2]
    got = lexsort_lanes(tuple(_i32(a[:, i]) for i in range(3)))
    want = a[np.lexsort((a[:, 2], a[:, 1], a[:, 0]))]
    assert np.array_equal(np.stack([_u32(x) for x in got], 1), want)
