"""The port's command line on --device cpu: post-assembly alignment, the
--post-asm-only rerun, restarts (--restart, --contigs/--prev-kmer-len, the
merged-reads checkpoint) and --profile, held against the JAX package's
run_pipeline and against an uninterrupted run (byte-identical files)."""

import logging
import os
import re

import numpy as np
import pytest

from mhm2_proxy_tpu.main import run_pipeline as ref_run_pipeline
from mhm2_proxy_tpu.options import parse_args as ref_parse_args
from mhm2_proxy_tpu_torch.io.fastq import write_fastq
from mhm2_proxy_tpu_torch.main import run_pipeline
from mhm2_proxy_tpu_torch.options import parse_args
from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads
from torch_common import one_torch_thread  # noqa: F401 (autouse fixture)


def make_data(rng, tmp_path, n=2000):
    genome = random_genome(rng, n)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=20.0, read_len=80, err_rate=0.002)
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, ids, seqs, quals)
    return fq


def run(args):
    return run_pipeline(parse_args(args + ["--device", "cpu"]))


def read(path, drop_pg=False):
    with open(path) as f:
        return "".join(x for x in f if not (drop_pg and x.startswith("@PG")))


def test_post_asm_and_post_asm_only_equal_reference(tmp_path):
    """-k 21 33 --post-asm-align --post-asm-abundance, then --post-asm-only
    on the same directory: the FASTA, the SAM (without @PG) and the depths
    equal the JAX package's."""
    fq = make_data(np.random.default_rng(21), tmp_path, n=3000)
    flags = ["--post-asm-align", "--post-asm-abundance", "--block-reads", "1024"]
    dirs = {}
    for name, parse, runner in (("ref", ref_parse_args, ref_run_pipeline),
                                ("port", lambda a: parse_args(a + ["--device", "cpu"]),
                                 run_pipeline)):
        out = str(tmp_path / name)
        runner(parse(["-r", fq, "-k", "21", "33", "-o", out] + flags))
        files = [read(f"{out}/final_assembly.fasta"),
                 read(f"{out}/final_assembly.sam", drop_pg=True),
                 read(f"{out}/final_assembly_depths.tsv")]
        runner(parse(["-r", fq, "-o", out, "--post-asm-only"] + flags))
        files += [read(f"{out}/final_assembly.sam", drop_pg=True),
                  read(f"{out}/final_assembly_depths.tsv")]
        dirs[name] = files
    assert dirs["port"] == dirs["ref"]
    assert dirs["port"][1].count("\n") > 500 and dirs["port"][2] != dirs["port"][4]


def test_pipeline_checkpoint_restart(tmp_path):
    """--restart skips the rounds whose checkpoint exists and reruns the
    rest: the restarted run writes the uninterrupted run's FASTA."""
    fq = make_data(np.random.default_rng(34), tmp_path)
    out = str(tmp_path / "run")
    args = ["-r", fq, "-k", "21", "33", "-o", out, "--checkpoint", "--block-reads", "1024"]
    asm = run(args)
    final = read(f"{out}/final_assembly.fasta")
    assert final.count(">") >= 1 and os.path.exists(f"{out}/contigs-21.fasta")
    os.remove(f"{out}/contigs-33.fasta")
    os.remove(f"{out}/final_assembly.fasta")
    asm2 = run(args + ["--restart"])
    assert read(f"{out}/final_assembly.fasta") == final
    assert [c.seq for c in asm2.contigs] == [c.seq for c in asm.contigs]
    assert os.path.exists(f"{out}/contigs-33.fasta")
    log = read(f"{out}/mhm2_torch.log")
    assert "[restart] skipping k=21" in log and "[module] contigging k=33" in log


def test_restart_all_rounds_present(tmp_path):
    fq = make_data(np.random.default_rng(70), tmp_path, n=1200)
    out = str(tmp_path / "run2")
    args = ["-r", fq, "-k", "21", "-o", out, "--checkpoint", "--block-reads", "512"]
    asm = run(args)
    asm2 = run(args + ["--restart"])
    assert {c.seq for c in asm2.contigs} == {c.seq for c in asm.contigs} and asm.contigs


def test_midpipeline_restart_from_external_contigs(tmp_path):
    """-c/--contigs + --prev-kmer-len (docs/mhm_guide.md:285-309): a run
    seeded with an external contig checkpoint skips the rounds at or below
    its k and writes the uninterrupted run's FASTA."""
    fq = make_data(np.random.default_rng(191), tmp_path)
    out_full = str(tmp_path / "full")
    run(["-r", fq, "-k", "21", "33", "-o", out_full, "--checkpoint", "--block-reads", "1024"])
    final = read(f"{out_full}/final_assembly.fasta")
    assert final.count(">") >= 1
    ckpt = f"{out_full}/contigs-21.fasta"

    out_re = str(tmp_path / "re")
    run(["-r", fq, "-k", "21", "33", "-o", out_re, "--contigs", ckpt, "--checkpoint",
         "--block-reads", "1024"])
    assert read(f"{out_re}/final_assembly.fasta") == final
    assert not os.path.exists(f"{out_re}/contigs-21.fasta")  # round skipped
    assert os.path.exists(f"{out_re}/contigs-33.fasta")

    renamed = str(tmp_path / "external_ctgs.fa")
    os.rename(ckpt, renamed)
    out_re2 = str(tmp_path / "re2")
    run(["-r", fq, "-k", "21", "33", "-o", out_re2, "--contigs", renamed,
         "--prev-kmer-len", "21", "--block-reads", "1024"])
    assert read(f"{out_re2}/final_assembly.fasta") == final

    with pytest.raises(ValueError, match="prev-kmer-len"):
        run(["-r", fq, "-k", "33", "-o", str(tmp_path / "re3"), "--contigs", renamed,
             "--block-reads", "1024"])


def test_checkpoint_merged_and_restart_from_it(tmp_path):
    """--checkpoint-merged writes the merged reads; --restart reloads them in
    place of the pair merge and writes the same FASTA."""
    fq = make_data(np.random.default_rng(131), tmp_path, n=1500)
    out = str(tmp_path / "cm")
    args = ["-r", fq, "-k", "21", "-o", out, "--block-reads", "512"]
    asm = run(args + ["--checkpoint-merged"])
    from mhm2_proxy_tpu_torch.io.fastq import read_fastq

    _ids, seqs, _quals = read_fastq(f"{out}/reads-merged.fastq.gz")
    assert len(seqs) == len(asm.packed_reads)
    assert sum(len(s) for s in seqs) == asm.packed_reads.total_bases
    final = read(f"{out}/final_assembly.fasta")
    assert final.count(">") >= 1
    asm2 = run(args + ["--restart"])
    assert "[restart] reloaded merged reads checkpoint" in read(f"{out}/mhm2_torch.log")
    assert asm2.packed_reads.total_bases == asm.packed_reads.total_bases
    assert read(f"{out}/final_assembly.fasta") == final


def test_profile_writes_a_trace(tmp_path):
    fq = make_data(np.random.default_rng(5), tmp_path, n=1000)
    out = str(tmp_path / "prof")
    run(["-r", fq, "-k", "21", "-o", out, "--profile", "--block-reads", "512"])
    trace = f"{out}/profile/trace.json"
    assert os.path.getsize(trace) > 0 and "traceEvents" in read(trace)
    assert os.path.exists(f"{out}/final_assembly.fasta")


@pytest.mark.parametrize("flag", [["--shards", "2"], ["--hosts", "2", "--shards", "4"]])
def test_sharded_flags_raise(tmp_path, flag, caplog):
    """--shards 2 (both shards on the one device) and --hosts 2 --shards 4
    (2 hosts x 2 devices, the two-stage exchange with supermers) run and
    write the JAX package's FASTA and k-mer dump for the same flags."""
    import gzip

    caplog.set_level(logging.INFO, logger="mhm2_proxy_tpu")
    fq = make_data(np.random.default_rng(2), tmp_path)
    args = ["-r", fq, "-k", "21", "33", "--block-reads", "1024", "--dump-kmers"] + flag
    ref_run_pipeline(ref_parse_args(args + ["-o", str(tmp_path / "ref")]))
    asm = run(args + ["-o", str(tmp_path / "port")])
    final = read(str(tmp_path / "port" / "final_assembly.fasta"))
    assert final == read(str(tmp_path / "ref" / "final_assembly.fasta")) and final.count(">") >= 1
    dumps = [gzip.open(str(tmp_path / d / "kmers-33.txt.gz")).read() for d in ("port", "ref")]
    assert dumps[0] == dumps[1] and dumps[0].count(b"\n") > 1000
    log = read(str(tmp_path / "port" / "mhm2_torch.log"))
    assert "k=33: exchange" in log and "sharded stitch rounds" in log
    assert asm.round_stats[21]["records"] > 0
    # every exchange statistic (records, MiB, k-mers a record, presummed,
    # re-sent, spill rounds) equals the reference's
    exchange = re.compile(r"k=\d+: exchange .*")
    want = [r.getMessage() for r in caplog.records
            if r.name == "mhm2_proxy_tpu" and exchange.match(r.getMessage())]
    assert exchange.findall(log) == want and len(want) == 2
