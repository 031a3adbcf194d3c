"""The `asm_align` traffic kind (assemble, then align every read to the job's
own contigs): a whole run on the CPU on a tiny 2x150 bp community comes out
correct; a planted CIGAR fault, a planted depth fault and the 8-bit score
control come out not correct; the cell's five readers read recorded spans
and a real job's. On the card the cell runs traced at a small size."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.tests import communities

CELL = "cami_low12.asm_align"
READERS = ("post_asm_s.asm_align", "align_s.asm_align", "cigar_s.asm_align", "sam_s.asm_align",
           "ssw_roofline.asm_align")
TINY_PARAMS = {"warmup_pairs": 64, "check_reads": 400, "check_longest": 16}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cigar_op_changed(mp):
    """Every mapped record's first `=` run is written as `X`."""
    from mhm2_proxy_tpu_torch.models import post_asm

    orig = post_asm.sam_block

    def sam_block(names, out, rows, lens, cnames):
        lines = orig(names, out, rows, lens, cnames).split("\n")
        for i, line in enumerate(lines):
            f = line.split("\t")
            if len(f) > 5 and f[1] != "4" and "=" in f[5]:
                f[5] = f[5].replace("=", "X", 1)
                lines[i] = "\t".join(f)
        return "\n".join(lines)

    mp.setattr(post_asm, "sam_block", sam_block)


def _depth_row_changed(mp):
    """The first contig's depth in the depth table is one higher."""
    from mhm2_proxy_tpu_torch.models import post_asm

    orig = post_asm.post_asm_align

    def post_asm_align(asm, *a, **kw):
        out = orig(asm, *a, **kw)
        path = kw.get("abundance_fname")
        with open(path) as f:
            lines = f.read().splitlines()
        name, length, depth = lines[1].split("\t")
        lines[1] = f"{name}\t{length}\t{float(depth) + 1:.4f}"
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return out

    mp.setattr(post_asm, "post_asm_align", post_asm_align)


def _score_control(ctx, jobs):
    from benchmark.traffic import asm_align

    return asm_align.check(ctx, jobs, score_bits=8)


CASES = {
    "none": (None, None, ()),
    "cigar_op": (_cigar_op_changed, None, ("sam_records_wrong",)),
    "depth_row": (_depth_row_changed, None, ("depth_rows_wrong",)),
    "score_bits8": (None, _score_control, ("sam_records_wrong",)),
}


@pytest.mark.parametrize("case", CASES)
def test_cpu_run(case, monkeypatch):
    plant, check_fn, caught_by = CASES[case]
    if plant:
        plant(monkeypatch)
    cfg = communities.config("cami_low12_align", genomes=2, genome_len=12_000, pairs=720)
    wl = communities.workload("cami_low12_align", "asm_align", TINY_PARAMS)
    out = run.run_cell(CELL, 2**31 + 17, 0, False, device="cpu", require_chip=False,
                       config=cfg, workload=wl, check_fn=check_fn)
    assert out["correct"] is (case == "none")
    assert set(out["checks"]) == {"merge_pairs_differing", "round_contigs_differing",
                                  "final_contigs_differing", "sam_records_wrong",
                                  "sam_reads_missing", "depth_rows_wrong"}
    for name in caught_by:
        assert out["checks"][name]["value"] > 0, name
    if case == "none":
        assert all(c["value"] == 0 for c in out["checks"].values())
        assert out["attempted"] == 1 and out["failed"] == 0
        assert set(out["metrics"]) == {"setup_s", "assembly_s", "peak_mem_GB"}
    else:
        assert out["failed"] == 1


def test_readers_on_recorded_data():
    row = lambda s, **c: dict(calls=1, seconds=s, **c)  # noqa: E731
    jobs = [{"job": row(60.0), "post_asm": row(40.0), "post_asm.align": row(4.0, reads=9),
             "post_asm.tb_dp": row(20.0, tb_bytes=5), "post_asm.tb_walk": row(8.0),
             "post_asm.cigar_render": row(2.0), "post_asm.sam": row(6.0, sam_bytes=3)},
            {"job": row(70.0), "post_asm": row(50.0), "post_asm.align": row(6.0),
             "post_asm.tb_dp": row(24.0), "post_asm.tb_walk": row(10.0),
             "post_asm.cigar_render": row(4.0), "post_asm.sam": row(8.0)}]
    # two ssw calls of 1e9 and 3e9 cells in 2 + 2 ms
    meter = [("mhm2_ssw", (), 2e-3), ("mhm2_merge", (), 1.0), ("mhm2_ssw", (), 2e-3)]
    rec = dict(jobs=[{}, {}, {}], traced_job=2, trace=None, meter=meter, program_spans=jobs,
               int32_ops_per_s=1e13, ssw_cells=[10**9, 3 * 10**9])
    got = {m: run.metric_reader(m)(rec) for m in READERS}
    assert got == pytest.approx({"post_asm_s.asm_align": 45.0, "align_s.asm_align": 5.0,
                                 "cigar_s.asm_align": 34.0, "sam_s.asm_align": 7.0,
                                 "ssw_roofline.asm_align": 100 * (4e9 * 7.5 / 1e13) / 4e-3})
    assert got["ssw_roofline.asm_align"] == run.metric_reader("ssw_roofline.post_asm")(rec)
    # a parent without the alignment's own spans: those readers read nothing
    for j in jobs:
        del j["post_asm.align"], j["post_asm.sam"]
    assert run.metric_reader("align_s.asm_align")(rec) is None
    assert run.metric_reader("sam_s.asm_align")(rec) is None
    assert run.metric_reader("cigar_s.asm_align")(rec) == pytest.approx(34.0)
    del jobs[1]["post_asm.tb_walk"]
    assert run.metric_reader("cigar_s.asm_align")(rec) == pytest.approx(30.0)
    for m in READERS:
        assert run.metric_reader(m)(dict(jobs=[], meter=[], program_spans=None)) is None


def test_readers_on_a_job(tmp_path):
    """A whole CPU job of the CLI's pipeline with both post-assembly flags
    inside the five readers' hooks: the four span readers read it, their
    parts fit in the post_asm span, and the roofline reads nothing without
    a card's meter."""
    from mhm2_proxy_tpu_torch.io.fastq import write_fastq
    from mhm2_proxy_tpu_torch.main import run_pipeline
    from mhm2_proxy_tpu_torch.options import parse_args
    from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads

    rng = np.random.default_rng(3)
    ids, seqs, quals = simulate_reads(rng, random_genome(rng, 2000), coverage=15.0,
                                      read_len=80, err_rate=0.002, insert_mean=120)
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, ids, seqs, quals)
    with contextlib.ExitStack() as stack:
        hooks = [stack.enter_context(run.metric_module(m).hooks()) for m in READERS]
        run_pipeline(parse_args(["-r", fq, "-k", "21", "33", "-o", str(tmp_path / "j"),
                                 "--device", "cpu", "--block-reads", "256",
                                 "--post-asm-align", "--post-asm-abundance"]))
    rec = dict(jobs=[{}], traced_job=None, trace=None, meter=[], int32_ops_per_s=None)
    for h in hooks:
        rec.update(h.result())
    got = {m: run.metric_reader(m)(rec) for m in READERS}
    assert all(got[m] > 0 for m in READERS[:4]), got
    assert got["align_s.asm_align"] + got["cigar_s.asm_align"] + got["sam_s.asm_align"] \
        <= got["post_asm_s.asm_align"]
    assert got["ssw_roofline.asm_align"] is None
    job = rec["program_spans"][0]
    assert job["post_asm.align"]["reads"] >= job["post_asm.align"]["anchored"] > 0
    assert job["post_asm.tb_dp"]["tb_bytes"] > 0 and job["post_asm.sam"]["sam_bytes"] > 0


@pytest.mark.chip
def test_traced_run_on_the_card(cuda):
    from benchmark.tests.test_bench_card import _traced_run, small

    out = _traced_run(CELL, small("cami_low12_align"))
    assert out["correct"], out["checks"]
    assert set(READERS) <= set(out["metrics"])
    assert 0 < out["metrics"]["ssw_roofline.asm_align"]["value"] <= 100
    assert out["metrics"]["post_asm_s.asm_align"]["value"] > \
        out["metrics"]["align_s.asm_align"]["value"]
