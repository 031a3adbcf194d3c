"""The readers of the program's own spans (benchmark/lib/program_trace.py):
the five metrics on recorded data, their hooks recording once under five
nested entries, the sums of a real assembly's spans by job, and nothing
read from a tree without the tracer."""

from __future__ import annotations

import contextlib
import sys

import numpy as np
import pytest

from benchmark import run

READERS = ("ingest_parse_s.asm", "ingest_merge_s.asm", "count_pack_s.asm", "finalize_s.asm",
           "host_syncs.asm")


def _rec():
    row = lambda s, **c: dict(calls=1, seconds=s, **c)  # noqa: E731
    jobs = [{"job": row(30.0), "ingest.parse": row(8.0, syncs=0, bytes=9),
             "ingest.merge": row(0.5), "count.pack": row(3.0, syncs=2),
             "count.finalize": row(7.0, syncs=400), "finalize.cuts": row(1.0, syncs=10)},
            {"job": row(32.0, syncs=1), "ingest.parse": row(9.0), "ingest.merge": row(0.7),
             "count.pack": row(2.0), "count.finalize": row(8.0, syncs=600)}]
    return dict(jobs=[{}, {}, {}], traced_job=2, trace=None, meter=[], program_spans=jobs)


def test_readers_on_recorded_data():
    rec = _rec()
    got = {m: run.metric_reader(m)(rec) for m in READERS}
    assert got == pytest.approx({"ingest_parse_s.asm": 8.5, "ingest_merge_s.asm": 0.6,
                                 "count_pack_s.asm": 2.5, "finalize_s.asm": 7.5,
                                 "host_syncs.asm": (412 + 601) / 2})
    # a job without a span reads as not having run it
    del rec["program_spans"][1]["count.pack"]
    assert run.metric_reader("count_pack_s.asm")(rec) == pytest.approx(3.0)
    # a record without the program's spans (a tree without the tracer)
    for m in READERS:
        assert run.metric_reader(m)(dict(rec, program_spans=None)) is None
        assert run.metric_reader(m)({"jobs": []}) is None


def test_five_hooks_record_once():
    from mhm2_proxy_tpu_torch.utils import trace

    with contextlib.ExitStack() as stack:
        hooks = [stack.enter_context(run.metric_module(m).hooks()) for m in READERS]
        assert trace.is_recording()
        for _ in range(2):
            with trace.span("job"):
                with trace.span("ingest"):
                    with trace.span("ingest.parse"):
                        trace.count("bytes", 7)
                with trace.span("round", k=21):
                    with trace.span("count.finalize"):
                        pass
                    with trace.span("count.finalize"):
                        pass
        with trace.span("outside a job"):
            pass
    assert not trace.is_recording()
    results = [h.result() for h in hooks]
    assert all(r == results[0] for r in results)
    jobs = results[0]["program_spans"]
    assert len(jobs) == 2 and set(jobs[0]) == {"job", "ingest", "ingest.parse", "round",
                                               "count.finalize"}
    assert jobs[1]["ingest.parse"]["calls"] == 1 and jobs[1]["ingest.parse"]["bytes"] == 7
    assert jobs[0]["count.finalize"]["calls"] == 2
    assert jobs[0]["job"]["seconds"] >= jobs[0]["round"]["seconds"] >= \
        jobs[0]["count.finalize"]["seconds"]


def test_a_tree_without_the_tracer_reads_nothing(monkeypatch):
    from mhm2_proxy_tpu_torch import utils

    monkeypatch.setitem(sys.modules, "mhm2_proxy_tpu_torch.utils.trace", None)
    monkeypatch.delattr(utils, "trace", raising=False)
    with run.metric_module("host_syncs.asm").hooks() as hook:
        pass
    rec = dict(jobs=[{}], traced_job=None, trace=None, meter=[], **hook.result())
    assert hook.result() == {} and run.metric_reader("host_syncs.asm")(rec) is None


def test_an_assembly_summed_by_job(tmp_path):
    """Two whole assemblies on the CPU inside the hook: one entry a job,
    with every span the readers read."""
    import torch

    from mhm2_proxy_tpu_torch.io.fastq import write_fastq
    from mhm2_proxy_tpu_torch.main import run_pipeline
    from mhm2_proxy_tpu_torch.options import parse_args
    from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads

    rng = np.random.default_rng(3)
    ids, seqs, quals = simulate_reads(rng, random_genome(rng, 2000), coverage=15.0,
                                      read_len=80, err_rate=0.002, insert_mean=120)
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, ids, seqs, quals)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with run.metric_module("finalize_s.asm").hooks() as hook:
            for i in range(2):
                run_pipeline(parse_args(["-r", fq, "-k", "21", "33", "-o", str(tmp_path / f"j{i}"),
                                         "--device", "cpu", "--block-reads", "256"]))
    finally:
        torch.set_num_threads(threads)
    rec = dict(jobs=[{}, {}], traced_job=None, trace=None, meter=[], **hook.result())
    assert len(rec["program_spans"]) == 2
    for j in rec["program_spans"]:
        assert j["job"]["calls"] == 1 and j["round"]["calls"] == 2
        assert j["count.finalize"]["calls"] == 2 and j["ingest.merge"]["pairs"] > 0
    for m in READERS[:-1]:
        assert run.metric_reader(m)(rec) > 0, m
    assert run.metric_reader("host_syncs.asm")(rec) == 0  # no card: nothing synchronises
