"""Port extract (plain version) vs the JAX reference: read_kmer_records +
pack_payload_into_lanes, and the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.constants import minimizer_len_for_k
from mhm2_proxy_tpu.ops import count as RC
from mhm2_proxy_tpu.ops.pallas_extract import extract_packed_lanes, extract_record_lanes
from mhm2_proxy_tpu_torch.ops import count as PC
from mhm2_proxy_tpu_torch.ops import extract as PE


def _block(seed, B, L, k):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, (B, L), dtype=np.uint8)
    codes[:, ::9] = rng.integers(0, 4, (B, len(range(0, L, 9))), dtype=np.uint8)
    qual_ok = rng.random((B, L)) > 0.1
    lens = rng.integers(k - 2, L + 1, B).astype(np.int32)
    return codes, qual_ok, lens


def _t(a):
    return torch.from_numpy(np.array(a))


def _u32(lanes):
    return [x.numpy().view(np.uint32) for x in lanes]


@pytest.mark.parametrize("k", [21, 33, 55, 99])
def test_packed_equals_records_plus_pack(k):
    codes, qual_ok, lens = _block(k, 12, k + 60, k)
    rec = RC.read_kmer_records(jnp.asarray(codes), jnp.asarray(qual_ok), jnp.asarray(lens), k,
                               minimizer_len_for_k(k), use_pallas=False)
    words = RC._sentinelize(rec["words"], rec["valid"])
    pay = jnp.where(rec["valid"], RC._pack_cnt_ext(rec["count"], rec["left"], rec["right"]), 0)
    weff = -(-2 * k // 32)
    want = RC.pack_payload_into_lanes(tuple(words[:, i] for i in range(weff)), pay, k)
    got = PE.extract_packed_lanes(_t(codes), _t(qual_ok), _t(lens), k)
    assert len(got) == weff
    for g, w in zip(_u32(got), want):
        assert np.array_equal(g, np.asarray(w))
    # the same records, unpacked, through the port's read_kmer_records
    prec = PC.read_kmer_records(_t(codes), _t(qual_ok), _t(lens), k)
    v = np.asarray(rec["valid"])
    assert np.array_equal(prec["valid"].numpy(), v)
    assert np.array_equal(prec["words"].numpy().view(np.uint32)[v], np.asarray(rec["words"])[v])
    for key in ("left", "right", "count"):
        assert np.array_equal(prec[key].numpy()[v], np.asarray(rec[key])[v]), key


@pytest.mark.parametrize("k", [21, 33])
def test_equals_pallas_interpret(k):
    codes, qual_ok, lens = _block(7 + k, 5, 64, k)
    args = (jnp.asarray(codes), jnp.asarray(qual_ok), jnp.asarray(lens))
    want = extract_packed_lanes(*args, k, interpret=True)
    got = PE.extract_packed_lanes(_t(codes), _t(qual_ok), _t(lens), k)
    for g, w in zip(_u32(got), want):
        assert np.array_equal(g, np.asarray(w).reshape(-1))
    want_l, want_p = extract_record_lanes(*args, k, interpret=True)
    got_l, got_p = PE.extract_record_lanes(_t(codes), _t(qual_ok), _t(lens), k)
    for g, w in zip(_u32(got_l) + _u32([got_p]), list(want_l) + [want_p]):
        assert np.array_equal(g, np.asarray(w).reshape(-1))


def test_contig_depths():
    """The contig pass: record layout with per-sequence depth."""
    k = 33
    codes, _q, lens = _block(11, 6, 300, k)
    depth = np.array([1, 7, 70000, 0, 3, 65535], np.int32)
    ones = np.ones_like(codes, bool)
    rec = RC.read_kmer_records(jnp.asarray(codes), jnp.asarray(ones), jnp.asarray(lens), k,
                               minimizer_len_for_k(k), depth=jnp.asarray(depth), use_pallas=False)
    got = PC.read_kmer_records(_t(codes), _t(ones), _t(lens), k, depth=_t(depth))
    v = np.asarray(rec["valid"])
    for key in ("left", "right", "count"):
        assert np.array_equal(got[key].numpy()[v], np.asarray(rec[key])[v]), key
