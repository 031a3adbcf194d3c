"""The port's supervisor (mhm2_proxy_tpu_torch/launcher.py: auto-resume with
fault injection, failure classes, scheduler rendezvous) and its run-log
parser: the analogs of tests/test_launcher.py, plus torch's CUDA
out-of-memory message and the parser on a port log."""

import os
import subprocess
import sys

from mhm2_proxy_tpu_torch.io.fasta import read_fasta
from mhm2_proxy_tpu_torch.io.fastq import write_fastq
from mhm2_proxy_tpu_torch.launcher import (classify_failure, detect_scheduler_env,
                                           rounds_completed)
from mhm2_proxy_tpu_torch.parse_run_log import format_table, parse_modules
from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **extra)
    return env


def test_classify_failure():
    assert classify_failure("", -9) == "killed by signal 9 (SIGKILL)"
    assert classify_failure("x\nstd::bad_alloc\n", 1) == "out of memory"
    assert "exception" in classify_failure("ValueError: boom", 1)
    assert classify_failure("fine", 3) == "exit code 3"


def test_classify_torch_cuda_out_of_memory():
    msg = ("Traceback (most recent call last):\n"
           "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 "
           "has a total capacity of 79.19 GiB of which 3.12 GiB is free.\n")
    assert classify_failure(msg, 1) == "out of memory"
    assert classify_failure("RuntimeError: CUDA out of memory.\n", 1) == "out of memory"


def test_rounds_completed(tmp_path):
    open(tmp_path / "contigs-21.fasta", "w").write(">c\nA\n")
    assert rounds_completed(str(tmp_path), (21, 33)) == 1


def test_auto_resume_after_mid_run_kill(tmp_path, rng):
    """SIGKILL after round 1 -> supervisor resumes with --restart -> output
    equals an uninterrupted run."""
    genome = random_genome(rng, 1500)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=10.0, read_len=70, err_rate=0.0)
    if len(seqs) % 2:
        ids, seqs, quals = ids[:-1], seqs[:-1], quals[:-1]
    fastq = str(tmp_path / "reads.fastq")
    write_fastq(fastq, ids, seqs, quals)
    base = ["-r", fastq, "-k", "21", "33", "--block-reads", "64", "--min-ctg-print-len", "0",
            "--device", "cpu"]

    def run_supervised(outdir, crash_round=None):
        extra = {"MHM2_TPU_TEST_CRASH_ROUND": str(crash_round)} if crash_round else {}
        return subprocess.run(
            [sys.executable, "-m", "mhm2_proxy_tpu_torch.launcher", *base, "-o", outdir],
            env=_env(**extra), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT, timeout=300)

    # the crash variable persists into the resumed child, but round 21 is
    # checkpoint-skipped on restart, so the injection never fires again
    p = run_supervised(str(tmp_path / "crashed"), crash_round=21)
    assert "auto-resuming with --restart" in p.stdout, p.stdout[-3000:]
    assert "killed by signal 9" in p.stdout and "skipping k=21" in p.stdout, p.stdout[-3000:]
    assert p.returncode == 0, p.stdout[-3000:]

    p2 = run_supervised(str(tmp_path / "clean"))
    assert p2.returncode == 0, p2.stdout[-3000:]

    got = sorted(seq for _, seq in read_fasta(str(tmp_path / "crashed" / "final_assembly.fasta")))
    exp = sorted(seq for _, seq in read_fasta(str(tmp_path / "clean" / "final_assembly.fasta")))
    assert got == exp and len(got) > 0

    # the run log's [module] lines, tabulated
    entries = parse_modules(open(tmp_path / "clean" / "mhm2_torch.log"))
    assert [name for name, _ in entries] == ["merge_reads", "contigging k=21",
                                             "contigging k=33"]
    assert format_table(entries).splitlines()[-1].startswith("TOTAL")


def test_no_resume_when_nothing_completed(tmp_path):
    p = subprocess.run(
        [sys.executable, "-m", "mhm2_proxy_tpu_torch.launcher",
         "-r", str(tmp_path / "missing.fastq"), "-o", str(tmp_path / "out"), "--device", "cpu"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT, timeout=300,
    )
    assert p.returncode != 0
    assert "not resuming" in p.stdout


def test_detect_scheduler_env_slurm():
    env = {"SLURM_PROCID": "3", "SLURM_NTASKS": "8",
           "SLURM_LAUNCH_NODE_IPADDR": "10.0.0.5"}
    got = detect_scheduler_env(env)
    assert got == {"MHM2_TPU_NUM_PROCS": "8", "MHM2_TPU_PROC_ID": "3",
                   "MHM2_TPU_COORDINATOR": "10.0.0.5:8476"}
    # explicit rendezvous config wins over scheduler detection
    env["MHM2_TPU_NUM_PROCS"] = "2"
    assert detect_scheduler_env(env) is None
    # single-task jobs don't trigger distributed init
    assert detect_scheduler_env({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}) is None


def test_detect_scheduler_env_mpi_and_lsf():
    got = detect_scheduler_env(
        {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "4",
         "MHM2_TPU_COORDINATOR": "h0:9999"})
    assert got["MHM2_TPU_PROC_ID"] == "1"
    assert got["MHM2_TPU_COORDINATOR"] == "h0:9999"
    # LSF task ids are 1-based
    got = detect_scheduler_env({"LSF_PM_TASKID": "2", "LSF_PM_NUMPROCS": "4"})
    assert got["MHM2_TPU_PROC_ID"] == "1"
    assert detect_scheduler_env({}) is None


def test_parse_run_log_reads_the_multi_process_line():
    """A multi-process run's [module] line (main.log_module over min_sum_max)
    tabulates at its average; the one-process form beside it."""
    lines = [
        "12:00:00 [module] merge_reads 1.50s (min 1.25 max 1.75 over 2 procs)",
        "12:00:01 [module] contigging k=21 2.50s",
        "12:00:02 unrelated line",
    ]
    assert parse_modules(lines) == [("merge_reads", 1.5), ("contigging k=21", 2.5)]
    table = format_table(parse_modules(lines)).splitlines()
    assert table[1].split()[:2] == ["merge_reads", "1.50"] and "37.5%" in table[1]
