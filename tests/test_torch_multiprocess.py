"""Two processes of the port's worker (parallel/worker.py) on the CPU over
gloo, each ingesting its own byte range of a shared FASTQ, counting through
the hierarchical two-stage exchange across the processes, traversing and
writing one FASTA together: both ranks' contigs equal the JAX package's
single-host assembly of the same reads (the analogs of
tests/test_multiprocess.py's two tests), at tolerance 0 for sequences and
1e-9 relative for depths."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from mhm2_proxy_tpu.constants import QUAL_CUTOFF
from mhm2_proxy_tpu.dbjg import traverse_debruijn_graph
from mhm2_proxy_tpu.io.fasta import read_fasta
from mhm2_proxy_tpu.io.fastq import write_fastq
from mhm2_proxy_tpu.kcount import KmerCountStore
from mhm2_proxy_tpu.models.assembler import Assembler, AssemblerConfig, _lists_to_block
from mhm2_proxy_tpu.utils.synth import random_genome, simulate_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(tmp_path, fastq: str, n: int = 2, extra=()) -> list:
    """n worker processes on the CPU; returns each rank's contig list."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "mhm2_proxy_tpu_torch.parallel.worker", str(pid), str(n),
             str(port), fastq, str(tmp_path), "--device", "cpu", *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT)
        for pid in range(n)
    ]
    outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [json.load(open(tmp_path / f"contigs-{pid}.json")) for pid in range(n)]


def check_against(tmp_path, got, exp):
    c0, c1 = got
    assert c0 == c1 and len(c0) > 0
    assert [s for s, _ in c0] == [s for s, _ in exp]
    np.testing.assert_allclose([d for _, d in c0], [d for _, d in exp], rtol=1e-9)
    # the cooperative FASTA write: every contig exactly once, in order
    fa = [seq for _, seq in read_fasta(str(tmp_path / "final_assembly.fasta"))]
    assert fa == [s for s, _ in exp]


def test_two_process_assembly_equals_single(tmp_path, rng):
    genome = random_genome(rng, 1200)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=10.0, read_len=72, err_rate=0.0)
    fastq = str(tmp_path / "reads.fastq")
    write_fastq(fastq, ids, seqs, quals)
    got = run_workers(tmp_path, fastq)

    # per-rank log fan-out (utils/logger.py, reference log.cpp:281-313):
    # rank 0 writes the main log; every rank writes a per_rank debug log
    assert (tmp_path / "mhm2_torch.log").exists()
    for r in range(2):
        rank_log = tmp_path / "per_rank" / "00000000" / f"{r:08d}" / "mhm2_torch.log"
        body = rank_log.read_text()
        assert f"worker {r}/2 up" in body and "per-rank debug stream" in body
        assert "backend gloo (the run's device is the CPU)" in body
    reports = [json.load(open(tmp_path / f"worker-{r}.json")) for r in range(2)]
    assert all(rep["transport"]["bytes"] > 0 and rep["count_transport"]["bytes"] > 0
               for rep in reports)

    k = 21
    store = KmerCountStore(k)
    codes, q, lens = _lists_to_block(seqs, quals, 32, 33)
    store.add_reads_block(codes, q >= 33 + QUAL_CUTOFF, lens)
    check_against(tmp_path, got, sorted(traverse_debruijn_graph(store.finalize(), k)))


def test_two_process_two_file_assembly_equals_single(tmp_path, rng):
    """f1:f2 across processes: byte ranges aligned to a common pair boundary
    in files of different record sizes, the pair merge, read-id disjointness
    checked."""
    genome = random_genome(rng, 1500)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=10.0, read_len=80, err_rate=0.0)
    f1, f2 = str(tmp_path / "p_1.fastq"), str(tmp_path / "p_2.fastq")
    write_fastq(f1, ids[0::2], seqs[0::2], quals[0::2])
    # mate-2 records trimmed shorter: the two files' record sizes differ
    write_fastq(f2, ids[1::2], [s[:64] for s in seqs[1::2]], [q[:64] for q in quals[1::2]])
    paired = f"{f1}:{f2}"
    got = run_workers(tmp_path, paired)

    k = 21
    asm = Assembler(AssemblerConfig(kmer_lens=(k,), block_reads=64))
    asm.load_reads([paired])
    store = KmerCountStore(k)
    for codes, q, lens in asm.packed_reads.blocks(64, min_len=k):
        store.add_reads_block(codes, q >= 33 + QUAL_CUTOFF, lens)
    check_against(tmp_path, got, sorted(traverse_debruijn_graph(store.finalize(), k)))


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
