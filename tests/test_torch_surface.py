"""The reference's public helpers in the port, against the JAX package on
the CPU: Assembler.add_interleaved, post_asm.sam_record, the bitkmer host
helpers and lex_less, the names mhm2_proxy_tpu/ops/__init__.py exports, and
the card default of the from_reference constructors."""

import ast
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhm2_proxy_tpu.models import Assembler as RefAssembler
from mhm2_proxy_tpu.models import AssemblerConfig as RefConfig
from mhm2_proxy_tpu.models import post_asm as RP
from mhm2_proxy_tpu.ops import bitkmer as RB
from mhm2_proxy_tpu_torch.models import post_asm as PP
from mhm2_proxy_tpu_torch.models.assembler import Assembler, AssemblerConfig
from mhm2_proxy_tpu_torch.ops import bitkmer as PB
from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("no_native", [None, "1"])
def test_add_interleaved_equals_reference(no_native, monkeypatch):
    """The same packed reads, qualities, lengths and ids, through the native
    merge and through the port's device merge."""
    rng = np.random.default_rng(5)
    genome = random_genome(rng, 4000)
    _, seqs, quals = simulate_reads(rng, genome, coverage=6.0, read_len=90, insert_mean=140,
                                    insert_sd=20, err_rate=0.01)
    seqs = [s.decode() for s in seqs][:160] + ["", "ACGT" * 5]
    quals = [q.decode() for q in quals][:160] + ["", "I" * 20]
    ref = RefAssembler(RefConfig())
    ref.add_interleaved(seqs, quals)
    if no_native:
        monkeypatch.setenv("MHM2_NO_NATIVE_MERGE", no_native)
    else:
        monkeypatch.delenv("MHM2_NO_NATIVE_MERGE", raising=False)
    port = Assembler(AssemblerConfig(device="cpu"))
    port.add_interleaved(seqs, quals)
    assert port._n_merged == ref._n_merged > 20 and port._n_pairs == ref._n_pairs
    assert len(port.packed_reads) == len(ref.packed_reads)
    got = list(port.packed_reads.blocks(64, with_ids=True))
    want = list(ref.packed_reads.blocks(64, with_ids=True))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for x, y in zip(g, w, strict=True):
            np.testing.assert_array_equal(x, y)


def _alignment_block():
    """A post-asm `out` dict of five reads: forward and reverse hits, a read
    with no hit, an empty read, and a hit on contig 2."""
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 5, (5, 12)).astype(np.uint8)
    out = dict(
        cid=np.array([0, 1, -1, 0, 2], np.int32),
        codes=codes,
        rev=np.array([False, True, False, False, True]),
        win_lo=np.array([3, 40, 0, 0, 7], np.int32),
        r_begin=np.array([2, 0, 0, 0, 5], np.int32),
        score=np.array([24, 18, 0, 0, 11], np.int32),
        cigar=["12M", "5M1I6M", "*", "*", "3S9M"],
        nm=np.array([0, 2, 0, 0, 1], np.int32),
    )
    lens = np.array([12, 12, 12, 0, 9], np.int32)
    return out, lens


@pytest.mark.parametrize("cnames", [None, ["Contig7", "Contig9", "Contig12"]])
@pytest.mark.parametrize("fields", ["cigar_nm", "cigar", "nm", "neither"])
def test_sam_record_equals_reference(fields, cnames):
    out, lens = _alignment_block()
    if "cigar" not in fields:
        del out["cigar"]
    if "nm" not in fields:
        del out["nm"]
    for i in range(len(lens)):
        want = RP.sam_record(f"r{i}/1", out, i, lens, cnames)
        assert PP.sam_record(f"r{i}/1", out, i, lens, cnames) == want
    if fields == "cigar_nm" and cnames:
        rows = np.arange(len(lens))
        block = PP.sam_block([f"r{i}/1" for i in rows], out, rows, lens, cnames)
        assert block == "".join(PP.sam_record(f"r{i}/1", out, i, lens, cnames) + "\n"
                                for i in rows)


def test_codes_to_ascii_equals_reference():
    codes = np.random.default_rng(2).integers(0, 5, 500).astype(np.uint8)
    assert PB.codes_to_ascii(codes) == RB.codes_to_ascii(codes)
    assert PB.codes_to_ascii(PB.ascii_to_codes(b"ACGTNacgtn")) == b"ACGTNACGTN"


@pytest.mark.parametrize("k", [15, 21, 33, 77])
def test_strings_to_words_equals_reference(k):
    rng = np.random.default_rng(k)
    kmers = ["".join(rng.choice(list("ACGTNacgt"), size=k)) for _ in range(40)]
    got = PB.strings_to_words(kmers, k)
    np.testing.assert_array_equal(got, RB.strings_to_words(kmers, k))
    assert got.dtype == np.uint32
    with pytest.raises(ValueError):
        PB.strings_to_words(["ACG"], k)


@pytest.mark.parametrize("W", [1, 2, 3])
def test_lex_less_equals_reference(W):
    """u32 order, words with the top bit set, and equal rows."""
    rng = np.random.default_rng(W)
    a = rng.integers(0, 1 << 32, (300, W), dtype=np.uint64).astype(np.uint32)
    a[:, 0] = rng.integers((1 << 31) - 2, (1 << 31) + 2, 300).astype(np.uint32)
    b = a.copy()
    b[::3, -1] ^= np.uint32(0x80000001)
    b[1::3] = rng.permutation(b[1::3])
    want = np.asarray(RB.lex_less(jnp.asarray(a), jnp.asarray(b)))
    got = PB.lex_less(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_ops_exports_the_reference_names():
    """Every name mhm2_proxy_tpu/ops/__init__.py imports (read as text)."""
    import mhm2_proxy_tpu_torch.ops as ops

    tree = ast.parse(open(os.path.join(ROOT, "mhm2_proxy_tpu", "ops", "__init__.py")).read())
    names = [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             for a in node.names]
    assert len(names) == 17
    missing = [n for n in names if not callable(getattr(ops, n, None))]
    assert not missing, missing


def test_from_reference_defaults_to_the_card():
    from mhm2_proxy_tpu_torch.kcount.kmer_store import FinalTable
    from mhm2_proxy_tpu_torch.parallel.sharded import ShardedTable

    for cls in (FinalTable, ShardedTable):
        assert inspect.signature(cls.from_reference).parameters["device"].default == "cuda"
