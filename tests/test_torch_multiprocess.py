"""Processes of the port's CLI on the CPU over gloo, joined by the
rendezvous variables (MHM2_TPU_NUM_PROCS, MHM2_TPU_PROC_ID,
MHM2_TPU_COORDINATOR), each ingesting its own byte range of the input and
counting through the hierarchical two-stage exchange across the
processes: their FASTA files equal the JAX package's single-device
assembly of the same reads, or one process's run at the same layout."""

import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

from mhm2_proxy_tpu.constants import QUAL_CUTOFF
from mhm2_proxy_tpu.dbjg import traverse_debruijn_graph
from mhm2_proxy_tpu.io.fasta import write_fasta
from mhm2_proxy_tpu.io.fastq import write_fastq
from mhm2_proxy_tpu.kcount import KmerCountStore
from mhm2_proxy_tpu.models.assembler import Assembler, AssemblerConfig
from mhm2_proxy_tpu.utils.synth import random_genome, simulate_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_contigs_fasta(fname, reads: str, k: int = 21) -> None:
    """The JAX package's single-device assembly of reads at k (its merge by
    Assembler.load_reads, a KmerCountStore, traverse_debruijn_graph), its
    contigs sorted and written as contigs-<k>.fasta by its write_fasta."""
    asm = Assembler(AssemblerConfig(kmer_lens=(k,), block_reads=64))
    asm.load_reads([reads])
    store = KmerCountStore(k)
    for codes, q, lens in asm.packed_reads.blocks(64, min_len=k):
        store.add_reads_block(codes, q >= 33 + QUAL_CUTOFF, lens)
    contigs = sorted(traverse_debruijn_graph(store.finalize(), k))
    write_fasta(str(fname), [(i, seq, depth) for i, (seq, depth) in enumerate(contigs)])


@pytest.mark.parametrize("layout", ["interleaved", "two_files"])
def test_cli_two_ranks_equal_jax_single_device(tmp_path, rng, layout):
    """Two CLI ranks over gloo at --hosts 2 --shards 4 on k = 21, each
    ingesting its own byte range: an interleaved FASTQ, or an 'f1:f2' pair
    whose mate-2 records are trimmed shorter (the two files' record sizes
    differ, so the ranges are aligned to a common pair boundary). The pairs
    are merged, counted through the hierarchical two-stage exchange and
    traversed by the sharded path, and contigs-21.fasta equals the JAX
    package's single-device assembly of the same merged reads, byte for
    byte (the analogs of tests/test_multiprocess.py's two tests)."""
    genome = random_genome(rng, 1500)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=10.0, read_len=80, err_rate=0.0)
    n = len(seqs) // 2 * 2
    if layout == "interleaved":
        reads = str(tmp_path / "reads.fastq")
        write_fastq(reads, ids[:n], seqs[:n], quals[:n])
    else:
        f1, f2 = str(tmp_path / "p_1.fastq"), str(tmp_path / "p_2.fastq")
        write_fastq(f1, ids[0:n:2], seqs[0:n:2], quals[0:n:2])
        write_fastq(f2, ids[1:n:2], [s[:64] for s in seqs[1:n:2]],
                    [q[:64] for q in quals[1:n:2]])
        reads = f"{f1}:{f2}"
    args = [sys.executable, "-m", "mhm2_proxy_tpu_torch", "-r", reads, "-k", "21",
            "--hosts", "2", "--shards", "4", "--device", "cpu", "--block-reads", "64"]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    port = free_port()
    procs = [subprocess.Popen(
        args + ["-o", str(tmp_path / "two")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        env=dict(env, MHM2_TPU_NUM_PROCS="2", MHM2_TPU_PROC_ID=str(pid),
                 MHM2_TPU_COORDINATOR=f"localhost:{port}")) for pid in range(2)]
    _jax_contigs_fasta(tmp_path / "jax.fasta", reads)
    for p in procs:
        out = p.communicate(timeout=120)[0].decode()
        assert p.returncode == 0, out[-3000:]
    want = open(tmp_path / "jax.fasta", "rb").read()
    assert want.count(b">") > 0
    assert open(tmp_path / "two" / "contigs-21.fasta", "rb").read() == want
    log = open(tmp_path / "two" / "mhm2_torch.log").read()
    assert "process 0 of 2, backend gloo" in log


def test_cli_two_processes_equal_one(tmp_path, rng):
    """The CLI joined to a group of two by the rendezvous variables, at
    --hosts 2 --shards 4 on k = 21 33 (the contig pass included): the FASTA
    equals one process's, and the [module] lines carry min / avg / max over
    the processes, which the run-log parser reads at their average."""
    from mhm2_proxy_tpu_torch.parse_run_log import parse_modules

    genome = random_genome(rng, 3000)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=12.0, read_len=80, err_rate=0.0)
    n = len(seqs) // 2 * 2
    fastq = str(tmp_path / "reads.fastq")
    write_fastq(fastq, ids[:n], seqs[:n], quals[:n])
    args = [sys.executable, "-m", "mhm2_proxy_tpu_torch", "-r", fastq, "-k", "21", "33",
            "--hosts", "2", "--shards", "4", "--device", "cpu", "--block-reads", "64"]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    port = free_port()
    procs = [subprocess.Popen(
        args + ["-o", str(tmp_path / "two")], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        env=dict(env, MHM2_TPU_NUM_PROCS="2", MHM2_TPU_PROC_ID=str(pid),
                 MHM2_TPU_COORDINATOR=f"localhost:{port}")) for pid in range(2)]
    one = subprocess.run(args + ["-o", str(tmp_path / "one")], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=120)
    assert one.returncode == 0, one.stdout.decode()[-3000:]
    for p in procs:
        out = p.communicate(timeout=120)[0].decode()
        assert p.returncode == 0, out[-3000:]
    fasta = [open(tmp_path / d / "final_assembly.fasta", "rb").read() for d in ("one", "two")]
    assert fasta[0] == fasta[1] and fasta[0].count(b">") > 0
    log = open(tmp_path / "two" / "mhm2_torch.log").read()
    assert "process 0 of 2, backend gloo" in log
    assert log.count("over 2 procs)") == 3
    assert [name for name, _ in parse_modules(log.splitlines())] == [
        "merge_reads", "contigging k=21", "contigging k=33"]


def _cli_group(args, out_dir, n: int, env: dict):
    """n CLI processes joined by the rendezvous variables, writing one
    output directory; returns their outputs."""
    port = free_port()
    procs = [subprocess.Popen(
        args + ["-o", str(out_dir)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        env=dict(env, MHM2_TPU_NUM_PROCS=str(n), MHM2_TPU_PROC_ID=str(pid),
                 MHM2_TPU_COORDINATOR=f"localhost:{port}")) for pid in range(n)]
    outs = [p.communicate(timeout=150)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_cli_four_ranks_ingest_their_own_bytes(tmp_path, rng):
    """Four CLI processes at --hosts 4 --shards 4 on k = 21 33: each rank
    parses only its own byte range of the interleaved FASTQ, cut between
    pairs (its `ingest.parse` bytes, from --profile's [trace] table in its
    per-rank log), and the round and final FASTA files equal one process's
    at the same layout."""
    from mhm2_proxy_tpu_torch.parallel.multihost import interleaved_pair_range

    genome = random_genome(rng, 3000)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=12.0, read_len=80, err_rate=0.002)
    n = len(seqs) // 2 * 2
    fastq = str(tmp_path / "reads.fastq")
    write_fastq(fastq, ids[:n], seqs[:n], quals[:n])
    args = [sys.executable, "-m", "mhm2_proxy_tpu_torch", "-r", fastq, "-k", "21", "33",
            "--hosts", "4", "--shards", "4", "--device", "cpu", "--block-reads", "64"]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    one = subprocess.Popen(args + ["-o", str(tmp_path / "one")], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    _cli_group(args + ["--profile"], tmp_path / "four", 4, env)
    out = one.communicate(timeout=150)[0].decode()
    assert one.returncode == 0, out[-3000:]
    for name in ("contigs-21.fasta", "contigs-33.fasta", "final_assembly.fasta"):
        got = [open(tmp_path / d / name, "rb").read() for d in ("one", "four")]
        assert got[0] == got[1] and got[0].count(b">") > 0, name
    log = open(tmp_path / "four" / "mhm2_torch.log").read()
    assert "process 0 of 4, backend gloo" in log
    size = os.path.getsize(fastq)
    parsed = []
    for r in range(4):
        body = (tmp_path / "four" / "per_rank" / "00000000" / f"{r:08d}" /
                "mhm2_torch.log").read_text()
        row = [line for line in body.splitlines() if "[trace] ingest.parse " in line][0]
        parsed.append(int(re.search(r"(?<!\w)bytes (\d+)", row).group(1)))
        lo, hi = interleaved_pair_range(fastq, r, 4)
        assert parsed[r] == (hi + 1 if r < 3 else size) - (lo + 1 if r else 0)
        assert abs(parsed[r] - size / 4) < 0.05 * size
    assert sum(parsed) == size


def _cli_setup(tmp_path, rng, n_ranks: int, flags=()):
    """A tiny community's interleaved FASTQ and the CLI's arguments at
    --hosts n --shards 4 on k = 21 33; one process's run of them in
    tmp_path/one, and the environment for a group."""
    genome = random_genome(rng, 3000)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=12.0, read_len=80, err_rate=0.002)
    n = len(seqs) // 2 * 2
    fastq = str(tmp_path / "reads.fastq")
    write_fastq(fastq, ids[:n], seqs[:n], quals[:n])
    args = [sys.executable, "-m", "mhm2_proxy_tpu_torch", "-r", fastq, "-k", "21", "33",
            "--hosts", str(n_ranks), "--shards", "4", "--device", "cpu",
            "--block-reads", "64", *flags]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    one = subprocess.run(args + ["-o", str(tmp_path / "one")], cwd=ROOT, env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=150)
    assert one.returncode == 0, one.stdout.decode()[-3000:]
    return args, env


def _fastq_records(fname):
    """The (bases, qualities) of a FASTQ's records, sorted: a rank's read ids
    start at rank x 2^44, so the names differ from one process's."""
    from mhm2_proxy_tpu_torch.io.fastq import read_fastq

    ids, seqs, quals = read_fastq(str(fname))
    assert len(set(ids)) == len(ids)
    return sorted(zip(seqs, quals))


def test_cli_ranks_checkpoint_merged_and_restart(tmp_path, rng):
    """Four ranks at --hosts 4 --shards 4 with --checkpoint-merged: the one
    reads-merged.fastq.gz holds every rank's reads once, the records of one
    process's checkpoint; a --restart of the four from it, with the rounds'
    files removed, reloads it and writes one process's FASTA."""
    args, env = _cli_setup(tmp_path, rng, 4, ["--checkpoint-merged"])
    four = tmp_path / "four"
    _cli_group(args, four, 4, env)
    ckpt = "reads-merged.fastq.gz"
    assert _fastq_records(four / ckpt) == _fastq_records(tmp_path / "one" / ckpt)
    final = open(tmp_path / "one" / "final_assembly.fasta", "rb").read()
    assert open(four / "final_assembly.fasta", "rb").read() == final
    for f in four.glob("*.fasta"):
        f.unlink()
    _cli_group(args + ["--restart"], four, 4, env)
    assert "[restart] reloaded merged reads checkpoint" in open(four / "mhm2_torch.log").read()
    assert open(four / "final_assembly.fasta", "rb").read() == final


def test_cli_ranks_post_asm_equal_one(tmp_path, rng):
    """Two ranks at --hosts 2 --shards 4 with --post-asm-align and
    --post-asm-abundance, each rank aligning its own reads: rank 0's SAM
    holds one process's header and records (in rank order, not the
    input's, and named by each rank's read ids), its depths file equals one
    process's, and no part file is left."""
    flags = ["--post-asm-align", "--post-asm-abundance"]
    args, env = _cli_setup(tmp_path, rng, 2, flags)
    _cli_group(args, tmp_path / "two", 2, env)
    sam = [open(tmp_path / d / "final_assembly.sam").read().splitlines()
           for d in ("one", "two")]
    head = [[ln for ln in s if ln.startswith("@")] for s in sam]
    body = [sorted(ln.split("\t", 1)[1] for ln in s if not ln.startswith("@")) for s in sam]
    assert head[0] == head[1] and body[0] == body[1] and len(body[0]) > 100
    depths = [open(tmp_path / d / "final_assembly_depths.tsv").read() for d in ("one", "two")]
    assert depths[0] == depths[1]
    assert not list((tmp_path / "two").glob("final_assembly.sam.*"))


def test_interleaved_ranges_cut_between_pairs(tmp_path, rng):
    """The ranks' byte ranges of an interleaved FASTQ partition it, and each
    starts at a mate 1: the naive cut at size * r / n falls inside a pair
    for some r here, and the cut moves to the next pair."""
    from mhm2_proxy_tpu_torch.io.stream import FastqStream
    from mhm2_proxy_tpu_torch.parallel.multihost import interleaved_pair_range

    genome = random_genome(rng, 2000)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=6.0, read_len=70, err_rate=0.0)
    n = len(seqs) // 2 * 2
    fastq = str(tmp_path / "reads.fastq")
    write_fastq(fastq, ids[:n], seqs[:n], quals[:n])
    for n_ranks in (2, 3, 4, 7):
        names = []
        for r in range(n_ranks):
            br = interleaved_pair_range(fastq, r, n_ranks)
            text = b"".join(FastqStream(fastq, 1 << 12, br).chunks())
            heads = [ln for ln in text.split(b"\n")[0::4] if ln]
            assert len(heads) % 2 == 0
            assert all(h.endswith(b"/1") for h in heads[0::2])
            assert all(a[:-2] == b[:-2] for a, b in zip(heads[0::2], heads[1::2]))
            names += heads
        assert names == [ln for ln in open(fastq, "rb").read().split(b"\n")[0::4] if ln]


def test_rank_rows_split_and_refuse_uneven(monkeypatch):
    """A rank of a multi-process run takes its shards' equal slices of a
    block's rows, and a block whose rows do not divide over the shards is
    refused, as the single process refuses it (the process count faked)."""
    from mhm2_proxy_tpu_torch.models import assembler as PA

    class Store:
        S, n_local, shard0 = 6, 3, 3

    monkeypatch.setattr(PA.comm, "world", lambda: 2)
    a, b = np.arange(24), np.arange(24) * 2
    got = PA._rank_rows(Store(), a, b)
    assert [x.tolist() for x in got] == [a[12:].tolist(), b[12:].tolist()]
    with pytest.raises(ValueError, match="do not divide over 6 shards"):
        PA._rank_rows(Store(), np.arange(16))


@pytest.mark.parametrize("n_shards,n_hosts", [(4, 2), (6, 2), (12, 3)])
def test_contig_blocks_divide_over_shards(rng, n_shards, n_hosts):
    """The contig pass's blocks divide over every shard count, as the rank
    split needs, and carry every contig window once."""
    from mhm2_proxy_tpu_torch.models import assembler as PA

    asm = PA.Assembler(PA.AssemblerConfig(device="cpu", n_shards=n_shards, n_hosts=n_hosts))
    asm.CTG_CELL_BUDGET = asm.CTG_MAX_SEG * 60
    asm.contigs = [PA.Contig(i, "".join(rng.choice(list("ACGT"), int(n))), 3.0)
                   for i, n in enumerate(rng.integers(30, 300, 130))]
    blocks = []

    class Store:
        def add_ctgs_block(self, codes, lens, deps):
            blocks.append(lens)

    asm._add_ctg_kmers(Store(), 21)
    assert len(blocks) > 1
    assert all(lens.shape[0] % n_shards == 0 for lens in blocks)
    got = sorted(int(n) for lens in blocks for n in lens if n)
    assert got == sorted(len(c.seq) for c in asm.contigs)
