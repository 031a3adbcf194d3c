"""The port's pair merge (mhm2_proxy_tpu_torch/io/merge.py) against the JAX
reference's merge_pairs_block and merge_reads_arrays, the native merge and
the reference's sequential oracle, on the CPU (tolerance 0 on every key).

The cases are tests/test_merge.py's (simulated pairs, no overlap, exact
overlap, Ns, the adversarial shortlist overflow, native against the block
merge) plus zero-length mates, all in one (B, 80) block, so the reference
compiles once a scan; qual_offset=64 is a block of its own."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.io import merge as R
from mhm2_proxy_tpu.oracle.merge_ref import merge_pair_oracle
from mhm2_proxy_tpu.oracle.pyref import revcomp_str
from mhm2_proxy_tpu_torch.io import merge as P
from mhm2_proxy_tpu_torch.io import native
from mhm2_proxy_tpu_torch.ops.bitkmer import ascii_to_codes, codes_to_ascii
from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads
from torch_common import one_torch_thread  # noqa: F401 (autouse fixture)

L = 80
ROW_KEYS = ("merged", "m_codes", "m_quals", "m_len", "overlap", "quals1_z", "quals2_z")


def pairs_to_arrays(pairs, L, qual_offset=33):
    B = len(pairs)
    c1 = np.full((B, L), 4, np.uint8)
    c2 = np.full((B, L), 4, np.uint8)
    q1 = np.full((B, L), qual_offset, np.uint8)
    q2 = np.full((B, L), qual_offset, np.uint8)
    l1 = np.zeros(B, np.int32)
    l2 = np.zeros(B, np.int32)
    for i, (s1, qs1, s2, qs2) in enumerate(pairs):
        c1[i, : len(s1)] = ascii_to_codes(s1.encode())
        q1[i, : len(qs1)] = np.frombuffer(qs1.encode(), np.uint8)
        c2[i, : len(s2)] = ascii_to_codes(s2.encode())
        q2[i, : len(qs2)] = np.frombuffer(qs2.encode(), np.uint8)
        l1[i], l2[i] = len(s1), len(s2)
    return c1, q1, l1, c2, q2, l2


def _sim_pairs(rng, glen, n, **kw):
    genome = random_genome(rng, glen)
    _, seqs, quals = simulate_reads(rng, genome, **kw)
    return [(seqs[i].decode(), quals[i].decode(), seqs[i + 1].decode(), quals[i + 1].decode())
            for i in range(0, len(seqs), 2)][:n]


def _cases(rng):
    """name -> list of (seq1, quals1, seq2, quals2), reads of at most L bases."""
    cases = {}
    cases["simulated"] = _sim_pairs(rng, 3000, 48, coverage=4.0, read_len=80, insert_mean=120,
                                    insert_sd=15, err_rate=0.01)
    cases["no_overlap"] = _sim_pairs(rng, 3000, 24, coverage=2.0, read_len=70, insert_mean=300,
                                     insert_sd=10, err_rate=0.0)
    genome = random_genome(rng, 2000)
    q = chr(33 + 38) * 80
    exact = []
    for _ in range(24):
        s = int(rng.integers(0, 1800))
        frag = genome[s: s + 120]
        exact.append((frag[:80], q, revcomp_str(frag[-80:]), q))
    cases["exact_overlap"] = exact
    genome = random_genome(rng, 1000)
    ns = []
    for _ in range(24):
        s = int(rng.integers(0, 800))
        frag = list(genome[s: s + 110])
        for _ in range(int(rng.integers(0, 5))):
            frag[int(rng.integers(0, 110))] = "N"
        frag = "".join(frag)
        qs = "".join(chr(33 + int(rng.integers(30, 41))) for _ in range(75))
        ns.append((frag[:75], qs, revcomp_str(frag[-75:]), qs))
    cases["ns"] = ns
    # poly-A, dinucleotide repeats and N-rich pairs pass the prefilter at
    # many shifts: the shortlist overflows
    hq = chr(70) * 80
    nrich = "".join(rng.choice(list("ACGTNNN"), size=80))
    cases["adversarial"] = [
        ("A" * 80, hq, "T" * 80, hq), ("AC" * 40, hq, "GT" * 40, hq),
        ("AT" * 40, hq, "AT" * 40, hq), ("CAG" * 26, hq[:78], "CTG" * 26, hq[:78]),
        ("ACNGT" * 16, hq, revcomp_str("ACNGT" * 16), hq), ("N" * 80, hq, "N" * 80, hq),
        (nrich, hq, revcomp_str(nrich), hq),
    ]
    mix = _sim_pairs(rng, 6000, 96, coverage=12.0, read_len=80, err_rate=0.01, insert_mean=110)
    mix = [("".join("N" if rng.random() < 0.01 else b for b in s1), q1,
            "".join("N" if rng.random() < 0.01 else b for b in s2), q2)
           for s1, q1, s2, q2 in mix]
    for i in range(0, 10):
        s1, q1, s2, q2 = mix[i]
        mix[i] = ("".join(rng.choice(list("ACGT"), size=len(s1))), q1, s2, q2)
    cases["native_mix"] = mix
    s1, q1, s2, q2 = cases["exact_overlap"][0]
    cases["zero_length"] = [("", "", s2, q2), (s1, q1, "", ""), ("", "", "", ""),
                            (s1[:12], q1[:12], s2[:12], q2[:12])]
    return cases


@pytest.fixture(scope="module")
def block():
    cases = _cases(np.random.default_rng(42))
    rows, pairs = {}, []
    for name, ps in cases.items():
        rows[name] = slice(len(pairs), len(pairs) + len(ps))
        pairs.extend(ps)
    return dict(pairs=pairs, rows=rows, arrays=pairs_to_arrays(pairs, L))


@pytest.fixture(scope="module")
def ref(block):
    """The reference on the whole block: merge_pairs_block per scan, its
    merge_reads_arrays on the block merge, and the native merge."""
    arrays = block["arrays"]
    out = {}
    for scan in ("dense", "shortlist"):
        r = R.merge_pairs_block(*map(jnp.asarray, arrays), scan=scan)
        out[scan] = {k: np.asarray(v) for k, v in r.items()}
    out["wrapper"] = R.merge_reads_arrays(*arrays, use_native=False)
    out["native"] = native.merge_pairs(*arrays)
    return out


def _rows(arrays, sl):
    return tuple(np.ascontiguousarray(a[sl]) for a in arrays)


def _assert_rows_equal(want, got, sl=slice(None)):
    for key in ROW_KEYS:
        np.testing.assert_array_equal(np.asarray(want[key])[sl], np.asarray(got[key]),
                                      err_msg=key)


@pytest.mark.parametrize("scan", ["dense", "shortlist"])
def test_block_equals_reference(block, ref, scan):
    """Every key of the whole block, the block sums included."""
    got = P.merge_pairs_block(*map(torch.from_numpy, block["arrays"]), scan=scan)
    _assert_rows_equal(ref[scan], {k: v.numpy() for k, v in got.items()})
    assert int(got["n_ambiguous"]) == int(ref[scan]["n_ambiguous"])
    assert bool(got["overflow"]) == bool(ref[scan]["overflow"]) == (scan == "shortlist")
    assert int(ref["dense"]["merged"].sum()) > 100  # the workload merges


CASES = ["simulated", "no_overlap", "exact_overlap", "ns", "adversarial", "native_mix",
         "zero_length"]


@pytest.mark.parametrize("scan", ["dense", "shortlist"])
@pytest.mark.parametrize("case", CASES)
def test_case_rows_equal_reference(block, ref, case, scan):
    """A case's rows alone give the reference's rows of the whole block,
    and the native merge's ambiguity count (the dense scan's)."""
    sl = block["rows"][case]
    args = _rows(block["arrays"], sl)
    got = P.merge_pairs_block(*map(torch.from_numpy, args), scan=scan)
    _assert_rows_equal(ref[scan], {k: v.numpy() for k, v in got.items()}, sl)
    if scan == "dense" or not bool(got["overflow"]):
        assert int(got["n_ambiguous"]) == native.merge_pairs(*args)["n_ambiguous"]
    assert bool(got["overflow"]) == (scan == "shortlist" and case == "adversarial")


@pytest.mark.parametrize("case", CASES)
def test_merge_reads_arrays_equals_reference_and_native(block, ref, case):
    sl = block["rows"][case]
    args = _rows(block["arrays"], sl)
    got = P.merge_reads_arrays(*args, use_native=False, device="cpu")
    assert "overflow" not in got
    _assert_rows_equal(ref["wrapper"], got, sl)
    nat = native.merge_pairs(*args)
    _assert_rows_equal(nat, got)
    assert int(got["n_ambiguous"]) == nat["n_ambiguous"]
    if case == "exact_overlap":
        assert got["merged"].sum() >= 20


def test_whole_block_merge_reads_arrays(block, ref):
    got = P.merge_reads_arrays(*block["arrays"], use_native=False, device="cpu")
    for want in (ref["wrapper"], ref["native"], ref["dense"]):
        _assert_rows_equal(want, got)
        assert int(got["n_ambiguous"]) == int(want["n_ambiguous"])


@pytest.mark.parametrize("case", ["simulated", "ns", "adversarial", "zero_length"])
def test_equals_oracle(block, case):
    """The reference's sequential mirror of merge_reads.cpp, pair by pair."""
    sl = block["rows"][case]
    got = P.merge_reads_arrays(*_rows(block["arrays"], sl), use_native=False, device="cpu")
    for i, (s1, qs1, s2, qs2) in enumerate(block["pairs"][sl]):
        em, eseq, equals = merge_pair_oracle(s1, qs1, s2, qs2)
        assert bool(got["merged"][i]) == em, (i, s1, s2)
        if em:
            n = int(got["m_len"][i])
            assert codes_to_ascii(got["m_codes"][i, :n]).decode() == eseq
            assert got["m_quals"][i, :n].tobytes().decode() == equals


def test_shortlist_overflow_falls_back_to_dense(block):
    """The adversarial rows overflow the shortlist; the other rows agree
    already, and the wrapper's dense rerun of the overflowing rows gives the
    dense scan everywhere."""
    args = tuple(map(torch.from_numpy, block["arrays"]))
    dense = P.merge_pairs_block(*args, scan="dense")
    short = P._merge_chunked(args, 33, "shortlist")
    adv = block["rows"]["adversarial"]
    over = short["overflow"].numpy()
    assert over[adv].sum() >= 5 and over.sum() == over[adv].sum()
    keep = ~over
    for key in ROW_KEYS:
        np.testing.assert_array_equal(dense[key].numpy()[keep], short[key].numpy()[keep])
    out = P.merge_reads_arrays(*block["arrays"], use_native=False, device="cpu")
    _assert_rows_equal({k: v.numpy() for k, v in dense.items()}, out)


def test_row_chunks_change_nothing(block, monkeypatch):
    """A block merged in chunks of 7 rows equals the one-chunk merge."""
    args = tuple(map(torch.from_numpy, block["arrays"]))
    whole = P.merge_pairs_block(*args, scan="shortlist")
    monkeypatch.setattr(P, "chunk_rows", lambda L: 7)
    chunked = P.merge_pairs_block(*args, scan="shortlist")
    for key in whole:
        assert torch.equal(whole[key], chunked[key]), key


def test_qual_offset_64():
    rng = np.random.default_rng(64)
    pairs = _sim_pairs(rng, 3000, 40, coverage=4.0, read_len=80, insert_mean=120,
                       insert_sd=15, err_rate=0.01)
    shift = lambda q: "".join(chr(ord(c) + 31) for c in q)  # noqa: E731
    pairs = [(s1, shift(q1), s2, shift(q2)) for s1, q1, s2, q2 in pairs]
    arrays = pairs_to_arrays(pairs, L, qual_offset=64)
    want = R.merge_reads_arrays(*arrays, qual_offset=64, use_native=False)
    nat = native.merge_pairs(*arrays, qual_offset=64)
    got = P.merge_reads_arrays(*arrays, qual_offset=64, use_native=False, device="cpu")
    dense = P.merge_pairs_block(*map(torch.from_numpy, arrays), qual_offset=64)
    assert got["merged"].sum() > 10
    for w in (want, nat, {k: v.numpy() for k, v in dense.items()}):
        _assert_rows_equal(w, got)
        assert int(w["n_ambiguous"]) == int(got["n_ambiguous"])


def _spy(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("env", [None, "1", "0"])
def test_environment_selects_the_merge(block, ref, env, monkeypatch, caplog):
    """use_native=None reads MHM2_NO_NATIVE_MERGE as the reference does:
    "1" runs the device merge (and says so), anything else the native one."""
    if env is None:
        monkeypatch.delenv("MHM2_NO_NATIVE_MERGE", raising=False)
    else:
        monkeypatch.setenv("MHM2_NO_NATIVE_MERGE", env)
    monkeypatch.setattr(P, "_LOGGED_REASONS", set())
    nat_calls = _spy(monkeypatch, native, "merge_pairs")
    dev_calls = _spy(monkeypatch, P, "_merge_rows")
    with caplog.at_level(logging.INFO, logger="mhm2_proxy_tpu_torch"):
        got = P.merge_reads_arrays(*block["arrays"], device="cpu")
    device = env == "1"
    assert bool(nat_calls) != device and bool(dev_calls) == device
    said = [r.getMessage() for r in caplog.records if "pair merge" in r.getMessage()]
    assert said == (["pair merge: the block-vectorized merge on cpu (the native merge is "
                     "turned off)"] if device else [])
    _assert_rows_equal(ref["native"], got)


def test_missing_library_runs_the_device_merge(block, ref, monkeypatch, caplog):
    monkeypatch.delenv("MHM2_NO_NATIVE_MERGE", raising=False)
    monkeypatch.setattr(native, "merge_available", lambda: False)
    monkeypatch.setattr(P, "_LOGGED_REASONS", set())
    with caplog.at_level(logging.INFO, logger="mhm2_proxy_tpu_torch"):
        got = P.merge_reads_arrays(*block["arrays"], device="cpu")
        P.merge_reads_arrays(*block["arrays"], device="cpu")
    said = [r.getMessage() for r in caplog.records if "pair merge" in r.getMessage()]
    assert said == ["pair merge: the block-vectorized merge on cpu (the host library "
                    "libmhm2_host.so, with the native merge, is not available)"]  # once a process
    _assert_rows_equal(ref["native"], got)
    assert int(got["n_ambiguous"]) == ref["native"]["n_ambiguous"]


def test_assembler_merge_stays_native(block, monkeypatch):
    """With the library present and MHM2_NO_NATIVE_MERGE unset, the CLI's
    ingest merges natively; with it set to 1 the device merge runs on the
    assembler's device, and both pack the same reads."""
    from mhm2_proxy_tpu_torch.models.assembler import Assembler, AssemblerConfig

    assert native.merge_available()
    seqs, quals = [], []
    for s1, q1, s2, q2 in block["pairs"][block["rows"]["simulated"]]:
        seqs += [s1, s2]
        quals += [q1, q2]
    packed = {}
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("MHM2_NO_NATIVE_MERGE", raising=False)
        else:
            monkeypatch.setenv("MHM2_NO_NATIVE_MERGE", env)
        nat_calls = _spy(monkeypatch, native, "merge_pairs")
        dev_calls = _spy(monkeypatch, P, "_merge_rows")
        asm = Assembler(AssemblerConfig(device="cpu"))
        asm.add_interleaved(seqs, quals)
        assert (len(nat_calls), bool(dev_calls)) == ((1, False) if env is None else (0, True))
        monkeypatch.undo()
        packed[env] = [tuple(map(np.copy, b)) for b in asm.packed_reads.blocks(64, with_ids=True)]
        assert asm._n_merged > 20
    for a, b in zip(packed[None], packed["1"], strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(x, y)
