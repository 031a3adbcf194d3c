"""The port's post-assembly alignment (models/post_asm.py, ops/lookup.py
table_lookup) against the JAX reference on the CPU: the contig index, the
lookup, and the SAM and depth files byte for byte (tolerance 0); and the
pass's spans and counters."""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mhm2_proxy_tpu.models import Assembler as RefAssembler
from mhm2_proxy_tpu.models import AssemblerConfig as RefConfig
from mhm2_proxy_tpu.models.assembler import Contig as RefContig
from mhm2_proxy_tpu.models import post_asm as R
from mhm2_proxy_tpu.ops.lookup import table_lookup as ref_table_lookup
from mhm2_proxy_tpu_torch.io.fastq import write_fastq
from mhm2_proxy_tpu_torch.models import post_asm as P
from mhm2_proxy_tpu_torch.models.assembler import Assembler, AssemblerConfig, Contig
from mhm2_proxy_tpu_torch.ops.bitkmer import ascii_to_codes
from mhm2_proxy_tpu_torch.ops.lookup import table_lookup
from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads
from torch_common import one_torch_thread  # noqa: F401 (autouse fixture)


def _contigs(rng):
    """Contigs that repeat a 31-mer across contigs and within one, one that
    is shorter than k, and one with an N."""
    g = random_genome(rng, 3000)
    rep = g[500:560]
    return [
        g[:1200],
        g[1100:2100] + rep + g[2100:2400],  # repeats g[500:560] of contig 0
        "ACGTACGTAC",  # shorter than k
        g[2300:3000],
        rep + g[1500:1530] + rep,  # the same 60-mer twice in one contig
        g[2600:2700] + "N" + g[2700:2800],
    ], g


def test_build_contig_index_equals_reference():
    contigs, _ = _contigs(np.random.default_rng(1))
    want = R.build_contig_index(contigs, 31)
    got = P.build_contig_index(contigs, 31, device="cpu")
    assert got["k"] == want["k"] == 31
    assert np.array_equal(got["words"].numpy().view(np.uint32), want["words"])
    for name in ("cid", "off", "rc", "concat", "cstart", "clen"):
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), name
    # repeated canonical k-mers keep the (contig, offset) order
    w = want["words"]
    dup = np.all(w[1:] == w[:-1], axis=1)
    assert dup.sum() >= 30
    assert P.build_contig_index(["ACGT", "AC"], 31, device="cpu") is None


def test_post_asm_defaults_to_the_card():
    """build_contig_index, and align_reads_to_contigs for the index it
    builds, default to CUDA: without a card they raise, with no silent CPU
    run."""
    import inspect

    contigs, g = _contigs(np.random.default_rng(1))
    for fn in (P.build_contig_index, P.align_reads_to_contigs):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    codes = ascii_to_codes(g[:100].encode())[None, :]
    lens = np.array([100], np.int32)
    if torch.cuda.is_available():
        assert P.build_contig_index(contigs, 31)["words"].is_cuda
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        P.build_contig_index(contigs, 31)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        P.align_reads_to_contigs(codes, lens, contigs, k=31)


def test_table_lookup_equals_reference():
    rng = np.random.default_rng(3)
    T, n_valid, W = 1000, 900, 2
    keys = rng.integers(0, 2**32, (T, W), dtype=np.uint64).astype(np.uint32)
    keys[::3, 0] |= np.uint32(1 << 31)  # both sides of bit 31
    keys[::7] = keys[1::7][: keys[::7].shape[0]]  # repeated rows
    keys = keys[np.lexsort(tuple(keys[:, w] for w in range(W - 1, -1, -1)))]
    keys[n_valid:] = 0xFFFFFFFF
    q = np.concatenate([keys[rng.integers(0, T, 300)],
                        rng.integers(0, 2**32, (200, W), dtype=np.uint64).astype(np.uint32)])
    q[::5, 1] ^= np.uint32(1)
    ri, rf = ref_table_lookup(jnp.asarray(keys), jnp.int32(n_valid), jnp.asarray(q))
    pi, pf = table_lookup(torch.from_numpy(keys.view(np.int32)), n_valid,
                          torch.from_numpy(q.view(np.int32)))
    rf = np.asarray(rf)
    assert np.array_equal(pf.numpy(), rf) and rf.sum() > 150
    assert np.array_equal(pi.numpy()[rf], np.asarray(ri)[rf])


def _assemblers(tmp_path, rng):
    contigs, g = _contigs(rng)
    ids, seqs, quals = simulate_reads(rng, g, coverage=12.0, read_len=90,
                                      insert_mean=160, insert_sd=20, err_rate=0.01)
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, ids, seqs, quals)
    ref = RefAssembler(RefConfig(kmer_lens=(21,), block_reads=1024))
    ref.load_reads([fq])
    ref.contigs = [RefContig(3 * i + 1, s, 2.0) for i, s in enumerate(contigs)]
    port = Assembler(AssemblerConfig(kmer_lens=(21,), block_reads=1024, device="cpu"))
    port.load_reads([fq])
    port.contigs = [Contig(3 * i + 1, s, 2.0) for i, s in enumerate(contigs)]
    return ref, port


def _files(tmp_path, name, fn):
    sam, dep = str(tmp_path / f"{name}.sam"), str(tmp_path / f"{name}.tsv")
    stats = fn(sam, dep)
    with open(sam) as f:
        lines = [x for x in f if not x.startswith("@PG")]
    return "".join(lines), open(dep).read(), stats


def test_post_asm_align_equals_reference(tmp_path):
    ref, port = _assemblers(tmp_path, np.random.default_rng(9))
    s_ref, d_ref, st_ref = _files(tmp_path, "ref", lambda s, d: R.post_asm_align(
        ref, sam_fname=s, abundance_fname=d, block_reads=512))
    s_port, d_port, st_port = _files(tmp_path, "port", lambda s, d: P.post_asm_align(
        port, sam_fname=s, abundance_fname=d, block_reads=512))
    assert s_port == s_ref and d_port == d_ref
    st_ref.pop("abundance_file")
    st_port.pop("abundance_file")
    assert st_port == st_ref
    assert P.post_asm_align_stats(port, sample_reads=300) == R.post_asm_align_stats(
        ref, sample_reads=300)
    records = [x.split("\t") for x in s_ref.splitlines() if not x.startswith("@")]
    mapped = [r for r in records if r[1] != "4"]
    assert len(mapped) > 0.8 * len(records) and any(r[1] == "16" for r in mapped)
    assert any("I" in r[5] or "D" in r[5] for r in mapped)


@pytest.mark.parametrize("block_reads", [64, 200])
def test_post_asm_block_size_leaves_files_unchanged(tmp_path, block_reads):
    """Every output is per read: blocks of 64 or 200 reads write the files
    of one 512-read block (read_<row> fallback names included)."""
    _, port = _assemblers(tmp_path, np.random.default_rng(9))
    # a block of anonymous reads: positional names across blocks
    codes, quals, lens = next(iter(port.packed_reads.blocks(100)))
    port.packed_reads.add_block(codes[:100], quals[:100], lens[:100])
    base = _files(tmp_path, "base", lambda s, d: P.post_asm_align(
        port, sam_fname=s, abundance_fname=d, block_reads=512))
    other = _files(tmp_path, "other", lambda s, d: P.post_asm_align(
        port, sam_fname=s, abundance_fname=d, block_reads=block_reads))
    assert other[:2] == base[:2]
    assert other[2]["aligned_frac"] == base[2]["aligned_frac"]
    assert "read_" in base[0]


def test_align_reads_direct():
    rng = np.random.default_rng(4)
    genome = random_genome(rng, 1500)
    idx = P.build_contig_index([genome], 31, device="cpu")
    B, L = 32, 80
    starts = rng.integers(0, len(genome) - L, B)
    codes = np.stack([ascii_to_codes(genome[s : s + L].encode()) for s in starts])
    lens = np.full(B, L, np.int32)
    out = P.align_reads_to_contigs(codes, lens, [genome], index=idx, k=31, cigars=True)
    assert (out["cid"] == 0).all() and (out["score"] == L).all()
    assert out["cigar"] == [f"{L}="] * B and not out["nm"].any()


TIMING_KEYS = {"index_s", "align_s", "tb_dp_s", "tb_walk_s", "cigar_render_s", "host_s",
               "reads_aligned"}


def test_post_asm_spans_cover_the_pass(tmp_path, monkeypatch):
    """Under a recording trace the pass's spans are the children of the
    caller's `post_asm` span and cover it; their counters equal the
    returned stats, the traceback codes' bytes and the SAM file's size,
    and timings keeps its keys, read from the spans."""
    from mhm2_proxy_tpu_torch.ops import ssw
    from mhm2_proxy_tpu_torch.utils import trace

    _, port = _assemblers(tmp_path, np.random.default_rng(9))
    shapes = []
    orig = ssw.global_tb_pointers

    def tb_pointers(*a, **kw):
        tb = orig(*a, **kw)
        shapes.append(tuple(tb.shape))
        return tb

    monkeypatch.setattr(ssw, "global_tb_pointers", tb_pointers)
    sam, dep = str(tmp_path / "t.sam"), str(tmp_path / "t.tsv")
    tm = {}
    with trace.recording() as spans:
        with trace.span("post_asm") as top:
            stats = P.post_asm_align(port, sam_fname=sam, abundance_fname=dep, block_reads=200,
                                     timings=tm)
    kids = [s for s in spans if s.name.startswith("post_asm.")]
    assert {s.name for s in kids} == {"post_asm.index", "post_asm.reads", "post_asm.align",
                                      "post_asm.tb_dp", "post_asm.tb_walk",
                                      "post_asm.cigar_render", "post_asm.sam"}
    assert all(s.parent == top.id for s in kids)
    covered = sum(s.t1 - s.t0 for s in kids)
    assert covered <= top.t1 - top.t0 and covered >= 0.99 * (top.t1 - top.t0)
    rows = trace.summary(spans)
    n_blocks = port.packed_reads.n_blocks(200)
    assert n_blocks > 1 and rows["post_asm.align"]["calls"] == n_blocks
    assert rows["post_asm.tb_dp"]["calls"] == n_blocks
    assert rows["post_asm.align"]["reads"] == stats["sampled_reads"] > 0
    assert rows["post_asm.align"]["anchored"] == tm["reads_aligned"] > 0
    assert rows["post_asm.tb_dp"]["tb_bytes"] == sum(int(np.prod(s)) for s in shapes)
    assert len(shapes) == n_blocks
    assert rows["post_asm.sam"]["sam_bytes"] == os.path.getsize(sam)
    assert set(tm) == TIMING_KEYS
    for key, name in (("index_s", "index"), ("align_s", "align"), ("tb_dp_s", "tb_dp"),
                      ("tb_walk_s", "tb_walk"), ("cigar_render_s", "cigar_render"),
                      ("host_s", "sam")):
        assert tm[key] == pytest.approx(rows[f"post_asm.{name}"]["seconds"], rel=1e-9), key


def test_post_asm_files_equal_with_and_without_recording(tmp_path):
    """A recording trace changes nothing the pass writes, and an untraced
    pass's timings keep their keys."""
    from mhm2_proxy_tpu_torch.utils import trace

    _, port = _assemblers(tmp_path, np.random.default_rng(9))
    tm = {}
    plain = _files(tmp_path, "plain", lambda s, d: P.post_asm_align(
        port, sam_fname=s, abundance_fname=d, block_reads=512, timings=tm))
    with trace.recording():
        traced = _files(tmp_path, "traced", lambda s, d: P.post_asm_align(
            port, sam_fname=s, abundance_fname=d, block_reads=512))
    assert traced[:2] == plain[:2]
    assert set(tm) == TIMING_KEYS and tm["reads_aligned"] > 0
