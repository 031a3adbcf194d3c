"""The `ranks` traffic kind on four processes: whole runs of the harness on
the CPU over gloo (this process is rank 0), a planted fault in one rank, a
rank that dies and a job that hangs (the watchdog), and the sharded
reference's rules on hand-made graphs. On four cards: the cell at a small
size over NCCL (`-m chip`; skipped on fewer cards)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.reference import sharded as ref
from benchmark.tests import communities

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
CELL = "cami_high68.ranks4"
SEED = 2**31 + 23


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny() -> dict:
    return communities.config("cami_high68", genomes=3, genome_len=12_000, pairs=960)


def _run_cpu(**kw) -> dict:
    return run.run_cell(CELL, SEED, 0, False, device="cpu", require_chip=False, config=tiny(),
                        params={"warmup_pairs": 64}, **kw)


def test_four_gloo_ranks_are_correct(capfd):
    out = _run_cpu()
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert {n: c["value"] for n, c in out["checks"].items()} == {
        "merge_pairs_differing": 0, "round_contigs_differing": 0,
        "final_contigs_differing": 0, "cyclic_contigs": 0}
    assert set(out["metrics"]) == {"setup_s", "assembly_s", "peak_mem_GB"}
    err = capfd.readouterr().err
    # every rank took a quarter of the pairs, and the process group is gone
    assert all(f"job 0 rank {r}: 240 pairs" in err for r in range(4))
    assert not torch.distributed.is_initialized()


def test_a_rank_that_leaves_a_block_out_is_not_correct(monkeypatch):
    """Rank 0 (this process) counts its first block of every round with
    every read's length set to 0; the other ranks count all of theirs."""
    from mhm2_proxy_tpu_torch.models import assembler

    orig = assembler.Assembler._read_blocks

    def read_blocks(self, *a):
        for i, (codes, ok, lens) in enumerate(orig(self, *a)):
            yield codes, ok, (np.zeros_like(lens) if i == 0 else lens)

    monkeypatch.setattr(assembler.Assembler, "_read_blocks", read_blocks)
    out = _run_cpu()
    assert not out["correct"]
    assert out["checks"]["round_contigs_differing"]["value"] > 0
    assert out["checks"]["merge_pairs_differing"]["value"] == 0


def test_the_control_is_not_correct():
    """The reference with its depths divided in float32 (the configuration
    states float64) against the program: every round's records differ."""
    from benchmark.traffic import ranks

    out = _run_cpu(check_fn=lambda ctx, jobs: ranks.check(ctx, jobs, depth_dtype="float32"))
    assert not out["correct"]
    assert out["checks"]["round_contigs_differing"]["value"] > 0
    assert out["checks"]["merge_pairs_differing"]["value"] == 0


@pytest.mark.parametrize("altered", [False, True])
def test_a_job_equal_to_an_earlier_one_takes_its_result(capfd, altered):
    """A second job of the run: with reads and files equal to the first's,
    its digests match and it takes the first's result; with one base of its
    contigs-33.fasta changed, it is checked in full and is not correct."""
    from benchmark.traffic import ranks

    def two_jobs(ctx, jobs):
        second = ranks.job(ctx, 1)
        if altered:
            path = os.path.join(second["out_dir"], "contigs-33.fasta")
            with open(path) as f:
                text = f.read()
            at = text.index("\n", text.index(">")) + 20
            with open(path, "w") as f:
                f.write(text[:at] + ("A" if text[at] != "A" else "C") + text[at + 1:])
        return ranks.check(ctx, jobs + [second])

    out = _run_cpu(check_fn=two_jobs)
    err = capfd.readouterr().err
    assert f"{2 if altered else 1} distinct jobs checked" in err
    assert out["correct"] is not altered
    assert out["checks"]["round_contigs_differing"]["value"] == (2 if altered else 0)
    assert out["checks"]["merge_pairs_differing"]["value"] == 0


SCRIPT = """
import json, os, sys, time
sys.path.insert(0, %(root)r)
import torch
torch.set_num_threads(1)
from benchmark import run
from benchmark.tests import communities
from benchmark.traffic import ranks
fault = %(fault)r
orig = ranks.job
def job(ctx, i):
    if fault == "kill":
        ctx.state["procs"][1].kill()
        print("killed", time.time(), file=sys.stderr, flush=True)
    else:
        from mhm2_proxy_tpu_torch import main
        run_pipeline = main.run_pipeline
        def slow(opts):
            time.sleep(60)
            return run_pipeline(opts)
        main.run_pipeline = slow
    return orig(ctx, i)
ranks.job = job
cfg = communities.config("cami_high68", genomes=3, genome_len=12_000, pairs=960)
out = run.run_cell(%(cell)r, 5, 0, False, device="cpu", require_chip=False, config=cfg,
                   params={"warmup_pairs": 64, "job_timeout_s": 3})
print(json.dumps(out))
"""


@pytest.mark.parametrize("fault", ["kill", "hang"])
def test_the_watchdog_ends_a_run_whose_rank_dies_or_hangs(fault):
    code = SCRIPT % dict(root=ROOT, fault=fault, cell=CELL)
    t0 = time.time()
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=180,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode == 3, p.stderr[-3000:]
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith('{"correct"')]
    why = "rank 2 exited" if fault == "kill" else "ran past 3 s"
    assert why in p.stderr, p.stderr[-3000:]
    if fault == "kill":
        killed = float(p.stderr.split("killed ")[1].split()[0])
        assert time.time() - killed < 60
    assert time.time() - t0 < 150


# -- the reference's rules ---------------------------------------------------------


def _reads(seqs, copies: int = 3):
    """High-quality reads of seqs, each `copies` times, laid end to end."""
    flat, starts, lens = ref._seq_tensors([s for s in seqs for _ in range(copies)],
                                          torch.device("cpu"))
    return flat, torch.ones_like(flat, dtype=torch.bool), starts, lens


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def test_every_path_is_rendered_and_cycles_compare_as_rotations():
    rng = np.random.default_rng(3)
    k = 21
    circle = "".join(rng.choice(list("ACGT"), 60))
    single = "".join(rng.choice(list("ACGT"), k + 2))  # one k-mer at position 1
    line = "".join(rng.choice(list("ACGT"), 80))
    # reads that wrap around the circle, two starts apart
    wraps = [(circle * 3)[i : i + 50] for i in range(0, 60, 2)]
    table = ref.count_round(_reads(wraps + [single, line]), [], k)
    got = ref.traverse(*table, k)
    seqs = [s for s, _ in got]
    assert single[1 : 1 + k] in seqs or _revcomp(single[1 : 1 + k]) in seqs
    from benchmark.reference.assemble import traverse as traverse_k2

    assert all(len(s) >= k + 2 for s, _ in traverse_k2(*table, k))
    assert [c for c in got if len(c[0]) >= k + 2] == traverse_k2(*table, k)
    cyc = [s for s in seqs if ref.is_cycle(s, k)]
    assert len(cyc) == 1 and len(cyc[0]) == 60 + k - 1
    want = ref.canonical_cycle(cyc[0], k)
    for r in range(0, 60, 7):
        rot = circle[r:] + circle[:r]
        for s in (rot + rot[: k - 1], _revcomp(rot + rot[: k - 1])):
            assert ref.canonical_cycle(s, k) == want
    assert ref.canonical_cycle(line, k) == line


def test_least_rotation_equals_brute_force():
    rng = np.random.default_rng(5)
    for n in (1, 2, 3, 7, 30):
        for _ in range(20):
            s = "".join(rng.choice(list("AC"), n))
            r = ref._least_rotation(s)
            assert s[r:] + s[:r] == min(s[i:] + s[:i] for i in range(n))


def test_ids_and_order_are_checked_apart_from_the_records():
    recs = ref.parse_records([">Contig0 2.5\nAC\n", ">Contig1 1.0\nGT\n", ">Contig3 1.0\nTT\n"])
    assert recs[0] == (0, "2.5", "AC") and ref.id_faults(recs) == 1
    assert ref.id_faults([recs[1], recs[0]]) == 3


def test_program_cycles_match_the_reference_as_rotations(tmp_path):
    """The program's --hosts 4 --shards 4 round on reads of a circle and a
    line, in one process: its contigs, every path and the cycle cut where
    the rank layout puts it, equal the reference's under the rotation rule."""
    from mhm2_proxy_tpu_torch.io.fasta import read_fasta
    from mhm2_proxy_tpu_torch.models.assembler import Assembler, AssemblerConfig

    rng = np.random.default_rng(11)
    k = 21
    circle = "".join(rng.choice(list("ACGT"), 90))
    line = "".join(rng.choice(list("ACGT"), 120))
    reads = [(circle * 3)[i : i + 60] for i in range(0, 90, 3)] + [line[i : i + 60]
                                                                   for i in range(0, 61, 3)]
    asm = Assembler(AssemblerConfig(kmer_lens=(k,), device="cpu", n_shards=4, n_hosts=4,
                                    block_reads=64, output_dir=str(tmp_path), checkpoint=True))
    asm.add_unpaired(reads * 2, ["I" * 60] * (2 * len(reads)))
    asm.run()
    got = [(int(n.split()[0][6:]), n.split()[1], s)
           for n, s in read_fasta(str(tmp_path / f"contigs-{k}.fasta"))]
    flat, ok, starts, lens = _reads(reads, copies=2)
    want = ref.expected_records(ref.traverse(*ref.count_round((flat, ok, starts, lens), [], k), k))
    assert sum(ref.is_cycle(s, k) for _, _, s in got) == 1
    assert sorted(ref.rotated(got, k)) == sorted(ref.rotated(want, k))
    assert ref.id_faults(got) == 0


def test_the_sharded_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.sharded; "
            "print(sorted(n for n in sys.modules if n.startswith('mhm2')))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


# -- on four cards -------------------------------------------------------------------


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


def small() -> dict:
    return communities.config("cami_high68", genomes=6, genome_len=300_000, pairs=96_000)


CARD_SCRIPT = """
import json, sys
import numpy as np
sys.path.insert(0, %(root)r)
from benchmark import run
if %(fault)r:
    from mhm2_proxy_tpu_torch.models import assembler
    orig = assembler.Assembler._read_blocks
    def read_blocks(self, *a):
        for i, (codes, ok, lens) in enumerate(orig(self, *a)):
            yield codes, ok, (np.zeros_like(lens) if i == 0 else lens)
    assembler.Assembler._read_blocks = read_blocks
print(json.dumps(run.run_cell(%(cell)r, %(seed)d, 1, %(trace)r, config=json.loads(%(cfg)r),
                              params={"warmup_pairs": 8192})))
"""


def _card_run(trace: bool, fault: bool):
    code = CARD_SCRIPT % dict(root=ROOT, fault=fault, cell=CELL, seed=SEED, trace=trace,
                              cfg=json.dumps(small()))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1]), p


@pytest.mark.chip
def test_four_cards_over_nccl(four_cards):
    """The cell at a small size: traced, every rank's own bytes and every
    metric; then a rank that leaves a block out is not correct."""
    out, p = _card_run(True, False)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in run.cell_metrics(
        run.benchmark_spec(), CELL, "per_layer")}
    assert 0 < out["metrics"]["alltoall_roofline.ranks4"]["value"] <= 100
    assert "process 0 of 4, backend nccl" in p.stdout + p.stderr
    parsed = [int(line.split("ingest.parse ")[1].split()[0]) for line in p.stderr.splitlines()
              if line.startswith("job 0 rank") and "ingest.parse" in line]
    assert len(parsed) == 4 and max(parsed) - min(parsed) < 0.01 * sum(parsed)
    out, _ = _card_run(False, True)
    assert not out["correct"] and out["checks"]["round_contigs_differing"]["value"] > 0


def test_exchange_readers_on_recorded_data():
    rec = dict(program_spans=[
        {"job": {"calls": 1, "seconds": 30.0},
         "count.exchange": {"calls": 40, "seconds": 2.0, "sent_bytes": 3_000_000_000,
                            "alltoall_bytes": 2_900_000_000},
         "traverse.exchange": {"calls": 90, "seconds": 5.0, "sent_bytes": 1_500_000_000,
                               "alltoall_bytes": 1_000_000_000}},
        {"job": {"calls": 1, "seconds": 32.0},
         "count.exchange": {"calls": 40, "seconds": 4.0, "sent_bytes": 3_000_000_000,
                            "alltoall_bytes": 2_900_000_000},
         "traverse.exchange": {"calls": 90, "seconds": 7.0, "sent_bytes": 1_500_000_000,
                               "alltoall_bytes": 1_000_000_000}}],
        trace=dict(busy_s=1.0, window_s=2.0, idle_by_span={},
                   device_ops={"ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)": 0.1,
                               "ncclDevKernel_AllReduce_Sum_i64_RING_LL(x)": 0.05,
                               "void at::native::vectorized_elementwise_kernel<4>": 3.0}))
    assert run.metric_reader("exchange_s.ranks4")(rec) == pytest.approx(3.0)
    assert run.metric_reader("stitch_exchange_s.ranks4")(rec) == pytest.approx(6.0)
    assert run.metric_reader("exchange_GB.ranks4")(rec) == pytest.approx(4.5)
    # the all-to-alls' bytes over the SendRecv kernels' seconds alone
    want = 100 * (3.9e9 / 450e9) / 0.1
    assert run.metric_reader("alltoall_roofline.ranks4")(rec) == pytest.approx(want)
    # a program without the exchange's spans and counters reads nothing
    bare = dict(program_spans=[{"job": {"calls": 1, "seconds": 30.0}}], trace=rec["trace"])
    for name in ("exchange_s.ranks4", "stitch_exchange_s.ranks4", "exchange_GB.ranks4",
                 "alltoall_roofline.ranks4"):
        assert run.metric_reader(name)(bare) is None
        assert run.metric_reader(name)(dict(jobs=[])) is None
