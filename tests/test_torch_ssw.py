"""The port's Smith-Waterman (ops/ssw.py, plain versions on the CPU) against
the JAX reference: the reference's SSW cases, the XLA column loop and the
Pallas kernel in interpret mode, and the batched CIGARs. Everything is
integer: tolerance 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mhm2_proxy_tpu.ops import ssw as R
from mhm2_proxy_tpu.ops.pallas_ssw import pallas_sw_align_ends
from mhm2_proxy_tpu_torch.ops import ssw as P
from mhm2_proxy_tpu_torch.ops.bitkmer import ascii_to_codes
from tests.test_ssw import CASES, SCORINGS
from torch_common import SCORING_WIDE, SCORINGS_ALL, one_torch_thread  # noqa: F401 (autouse)

# the CUDA kernel's strip width (csrc/ssw.cu's kStrip): the shapes below sit at
# its strip edges
STRIP = 32


def test_scorings_all_extends_the_reference_profiles():
    assert SCORINGS_ALL[:3] == SCORINGS
    assert SCORINGS_ALL[3]["gap_open"] < SCORINGS_ALL[3]["gap_extend"]


def _batch(pairs, pad=255):
    Lq = max(len(q) for q, _ in pairs)
    Lr = max(len(r) for _, r in pairs)
    B = len(pairs)
    q = np.full((B, Lq), pad, np.uint8)
    r = np.full((B, Lr), pad, np.uint8)
    ql = np.zeros(B, np.int32)
    rl = np.zeros(B, np.int32)
    for i, (qs, rs) in enumerate(pairs):
        q[i, : len(qs)] = ascii_to_codes(qs.encode())
        r[i, : len(rs)] = ascii_to_codes(rs.encode())
        ql[i], rl[i] = len(qs), len(rs)
    return q, ql, r, rl


def _port_align(q, ql, r, rl, **sc):
    aln = P.sw_align(*map(torch.from_numpy, (q, ql, r, rl)), **sc)
    return {k: v.numpy() for k, v in aln.items()}


def _ref_align(q, ql, r, rl, **sc):
    aln = R.sw_align(*map(jnp.asarray, (q, ql, r, rl)), **sc)
    return {k: np.asarray(v) for k, v in aln.items()}


def _mutated_pairs(rng, n, lo, hi, max_edits):
    pairs = []
    for _ in range(n):
        ref = "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi))))
        q = list(ref)
        for _ in range(int(rng.integers(0, max_edits + 1))):
            p = int(rng.integers(0, len(q)))
            op = int(rng.integers(0, 3))
            if op == 0:
                q[p] = "ACGT"[int(rng.integers(0, 4))]
            elif op == 1:
                q.insert(p, "ACGT"[int(rng.integers(0, 4))])
            elif len(q) > 5:
                del q[p]
        pairs.append(("".join(q), ref))
    return pairs


@pytest.mark.parametrize("scoring", SCORINGS)
def test_ssw_positions(scoring):
    aln = _port_align(*_batch([(q, r) for q, r, *_ in CASES]), **scoring)
    for i, (qs, rs, qb, qe, rb, re_, _mm, _cigar) in enumerate(CASES):
        got = (aln["q_begin"][i], aln["q_end"][i], aln["r_begin"][i], aln["r_end"][i])
        assert got == (qb, qe, rb, re_), (i, qs, rs, got)


@pytest.mark.parametrize("scoring", SCORINGS)
def test_ssw_cigars(scoring):
    pairs = [(q, r) for q, r, *_ in CASES]
    q, ql, r, rl = _batch(pairs)
    aln = _port_align(q, ql, r, rl, **scoring)
    cigars, mms = P.sw_cigar_batch(q, ql, r, rl, aln, **scoring)
    for i, (qs, rs, *_pos, mm, cigar) in enumerate(CASES):
        assert P.sw_cigar_host(qs, rs, aln, i, **scoring) == (cigar, mm), (i, qs, rs)
        assert (cigars[i], mms[i]) == (cigar, mm), (i, qs, rs, cigars[i])


@pytest.mark.parametrize("scoring", SCORINGS_ALL + [SCORING_WIDE])
def test_sw_align_ends_equals_reference(scoring):
    """The plain version == the reference's XLA loop == its Pallas kernel in
    interpret mode, at (16, 24, 40) with ragged lengths (0 included),
    ambiguous codes and pad bytes; the reference's profiles, go < ge, and a
    mismatch score past a signed byte."""
    rng = np.random.default_rng(7)
    B, Lq, Lr = 16, 24, 40
    ref = rng.integers(0, 5, (B, Lr)).astype(np.uint8)
    q = np.array(ref[:, 4 : 4 + Lq])
    mut = rng.random((B, Lq)) < 0.15
    q[mut] = ((q[mut] + rng.integers(1, 4, int(mut.sum()))) % 4).astype(np.uint8)
    q[3, 5:9] = 255
    ql = rng.integers(0, Lq + 1, B).astype(np.int32)
    rl = rng.integers(0, Lr + 1, B).astype(np.int32)
    ql[:2] = (0, Lq)
    rl[:2] = (Lr, 0)
    got = P.sw_align_ends(*map(torch.from_numpy, (q, ql, ref, rl)), **scoring)
    jargs = tuple(map(jnp.asarray, (q, ql, ref, rl)))
    want = R._sw_align_ends_xla(*jargs, **scoring)
    pallas = pallas_sw_align_ends(*jargs, **scoring, interpret=True)
    for g, w, p, name in zip(got, want, pallas, ("score", "q_end", "r_end")):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
        assert np.array_equal(g.numpy(), np.asarray(p)), name


@pytest.mark.parametrize("n", [STRIP - 1, STRIP, STRIP + 1, 2 * STRIP + 1])
def test_sw_align_ends_strip_edges_equal_reference(n):
    """Lq and Lr at the CUDA kernel's strip edges (R - 1, R, R + 1, 2R + 1
    for its strip width R), with ties across strips: the plain version ==
    the reference's XLA loop == its Pallas kernel in interpret mode."""
    S = STRIP
    rng = np.random.default_rng(n)
    pairs = [("CA", "T" * (S - 1) + "ACT"), ("GA", "AGT"), ("AC", "T" * (2 * S - 1) + "AC")]
    pairs = [(a[:n], b[:n]) for a, b in pairs]
    pairs += _mutated_pairs(rng, 13, max(n // 2, 6), n + 1, 3)
    pairs = [(a[:n], b[:n]) for a, b in pairs]
    q, ql, r, rl = _batch(pairs + [("A" * n, "A" * n)])
    rl[5] = max(rl[5] - 3, 0)
    for scoring in SCORINGS_ALL:
        got = P.sw_align_ends(*map(torch.from_numpy, (q, ql, r, rl)), **scoring)
        jargs = tuple(map(jnp.asarray, (q, ql, r, rl)))
        want = R._sw_align_ends_xla(*jargs, **scoring)
        pallas = pallas_sw_align_ends(*jargs, **scoring, interpret=True)
        for g, w, p, name in zip(got, want, pallas, ("score", "q_end", "r_end")):
            assert np.array_equal(g.numpy(), np.asarray(w)), name
            assert np.array_equal(g.numpy(), np.asarray(p)), name


@pytest.mark.parametrize("scoring", SCORINGS_ALL)
def test_sw_align_and_cigars_equal_reference(scoring):
    """sw_align and the batched CIGARs on random mutated pairs (and a
    dissimilar and an all-N pair) equal the reference's."""
    rng = np.random.default_rng(11)
    pairs = _mutated_pairs(rng, 30, 20, 70, 5)
    pairs += [("GCTAGCTAGCTAGCTA", "AAAATTTTCCCCGGGG"), ("NNNNNN", "ACGTAC")]
    q, ql, r, rl = _batch(pairs)
    got = _port_align(q, ql, r, rl, **scoring)
    want = _ref_align(q, ql, r, rl, **scoring)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    cg, mm = P.sw_cigar_batch(q, ql, r, rl, got, **scoring)
    cw, mw = R.sw_cigar_batch(q, ql, r, rl, want, **scoring)
    assert cg == cw
    assert np.array_equal(mm, mw)


def test_cigar_batch_long_runs_and_clips():
    """Runs and soft clips of 1, 2 and 3 digits render as the reference's."""
    rng = np.random.default_rng(5)
    core = "".join(rng.choice(list("ACGT"), 260))
    pairs = [
        ("".join(rng.choice(list("ACGT"), 120)) + core + "T" * 11, core),
        (core[:130] + "G" + core[131:], core),
        (core[:100] + core[112:], core),
        (core[:60] + "ACGTACGTACGT" + core[60:], core),
        ("", core[:10]),
    ]
    q, ql, r, rl = _batch(pairs)
    got = _port_align(q, ql, r, rl)
    cg, mm = P.sw_cigar_batch(q, ql, r, rl, got)
    cw, mw = R.sw_cigar_batch(q, ql, r, rl, _ref_align(q, ql, r, rl))
    assert cg == cw and np.array_equal(mm, mw)
    assert any(len(c) > 8 for c in cg) and cg[-1] == ""


@pytest.mark.parametrize("ge", [0, 1, 3])
def test_decay_max_scan(ge):
    rng = np.random.default_rng(ge)
    c = rng.integers(-50, 50, (6, 37)).astype(np.int32)
    c[:, 0] = P.NEG
    got = P.decay_max_scan(torch.from_numpy(c), ge).numpy()
    i = np.arange(37)
    want = np.max(np.where(i[None, :, None] >= i[None, None, :],
                           c[:, None, :] - (i[None, :, None] - i[None, None, :]) * ge,
                           np.iinfo(np.int32).min), axis=2)
    assert np.array_equal(got, want)
