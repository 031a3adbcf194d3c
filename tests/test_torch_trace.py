"""The port's tracer (mhm2_proxy_tpu_torch/utils/trace.py): spans, their
parents, jobs and self time, counters on the innermost span, nothing kept
and no sync mode set while nothing records, nested recordings that record
once, the stage laps; and the spans of a whole run_pipeline on the CPU,
which the run's own timings read."""

import functools
import os
import re
import warnings

import numpy as np
import pytest
import torch

from mhm2_proxy_tpu_torch.io.fastq import write_fastq
from mhm2_proxy_tpu_torch.kcount import kmer_store
from mhm2_proxy_tpu_torch.main import run_pipeline
from mhm2_proxy_tpu_torch.options import parse_args
from mhm2_proxy_tpu_torch.utils import trace
from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads
from torch_common import one_torch_thread  # noqa: F401 (autouse fixture)


class FakeCuda:
    """torch.cuda's sync debug mode and synchronize, recorded, on a machine
    that reports a card."""

    def __init__(self, monkeypatch):
        self.mode, self.modes, self.syncs = 0, [], 0
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: self.mode)
        monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", self._set)
        monkeypatch.setattr(torch.cuda, "synchronize", self._sync)

    def _set(self, mode):
        self.mode = {"default": 0, "warn": 1}.get(mode, mode)
        self.modes.append(mode)

    def _sync(self, dev=None):
        self.syncs += 1


def sync_warning():
    """What torch reports for a blocking CUDA operation in "warn" mode."""
    warnings.warn(trace.SYNC_MESSAGE + " (Triggered internally at CUDAFunctions.cpp:150.)",
                  UserWarning)


def by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_parents_jobs_and_self_time():
    with trace.recording(syncs=False) as rec:
        with trace.span("job") as job:
            with trace.span("round", k=21) as rnd:
                with trace.span("count") as cnt:
                    pass
                with trace.span("traverse") as trv:
                    pass
        with trace.span("job") as job2:
            pass
    assert [s.name for s in rec] == ["count", "traverse", "round", "job", "job"]
    assert (cnt.parent, trv.parent, rnd.parent, job.parent) == (rnd.id, rnd.id, job.id, 0)
    assert {s.job for s in rec[:4]} == {job.id} and job2.job == job2.id != job.id
    # a span's attributes reach every span inside it
    assert cnt.attrs == trv.attrs == rnd.attrs == {"k": 21} and job.attrs == {}
    rows = trace.summary(rec, job.id)
    assert list(rows) == ["job", "round", "count", "traverse"]
    assert rows["round"]["self_seconds"] == pytest.approx(
        rnd.seconds - cnt.seconds - trv.seconds, abs=1e-12)
    assert rows["job"]["self_seconds"] == pytest.approx(job.seconds - rnd.seconds, abs=1e-12)
    assert rows["count"]["calls"] == 1 and rows["count"]["seconds"] == cnt.seconds
    assert trace.summary(rec)["job"]["calls"] == 2


def test_counters_land_on_the_innermost_span():
    with trace.recording(syncs=False) as rec:
        with trace.span("ingest") as outer:
            trace.count("bytes", 10)
            with trace.span("ingest.parse") as inner:
                trace.count("bytes", 5)
                trace.count("reads", 2)
                trace.count("reads", 3)
            trace.count("bytes", 1)
    assert inner.counters == {"bytes": 5, "reads": 5}
    assert outer.counters == {"bytes": 11}
    rows = trace.summary(rec)
    assert rows["ingest.parse"]["reads"] == 5 and rows["ingest"]["bytes"] == 11


def test_nothing_kept_and_no_sync_mode_while_off(monkeypatch):
    cuda = FakeCuda(monkeypatch)
    assert not trace.is_recording()
    with trace.span("count", k=21) as sp:
        trace.count("raw_rows", 5)
        with warnings.catch_warnings(record=True) as shown:
            warnings.simplefilter("always")
            sync_warning()
    assert sp.id == 0 and sp.seconds >= 0 and len(shown) == 1
    assert not hasattr(sp, "counters") or not sp.counters
    assert trace._State.stack == [] and cuda.modes == []
    timings = {}
    t0 = trace.lap(None, "pack_s", trace.now(), torch.device("cuda"))
    assert cuda.syncs == 0 and isinstance(t0, int)
    trace.lap(timings, "pack_s", t0, torch.device("cuda"))
    assert cuda.syncs == 1 and set(timings) == {"pack_s"}


def test_syncs_counted_on_the_innermost_span_and_the_mode_restored(monkeypatch):
    cuda = FakeCuda(monkeypatch)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with trace.recording() as rec:
            assert cuda.mode == 1
            with trace.span("count.finalize"):
                sync_warning()
                with trace.span("finalize.cuts"):
                    sync_warning()
                    sync_warning()
                warnings.warn("something else", UserWarning)
        sync_warning()
    rows = trace.summary(rec)
    assert rows["count.finalize"]["syncs"] == 1 and rows["finalize.cuts"]["syncs"] == 2
    assert cuda.modes == ["warn", 0] and cuda.mode == 0
    # the sync warnings were counted, not shown; the others pass through,
    # and after the recording the sync warning shows again
    assert [str(w.message) for w in shown] == ["something else", str(shown[1].message)]
    assert str(shown[1].message).startswith(trace.SYNC_MESSAGE)


def test_nested_recordings_record_once(monkeypatch):
    cuda = FakeCuda(monkeypatch)
    with trace.recording() as a:
        with trace.recording() as b, trace.recording() as c:
            with trace.span("job"):
                sync_warning()
        assert trace.is_recording() and cuda.modes == ["warn"]
        with trace.span("job"):
            pass
    assert not trace.is_recording() and cuda.modes == ["warn", 0]
    assert a is b is c and [s.name for s in a] == ["job", "job"]
    assert a[0].counters == {"syncs": 1}
    with trace.recording(syncs=False) as d:
        pass
    assert d is not a and d == [] and cuda.modes == ["warn", 0]


def test_lap_records_a_finished_span_under_the_open_one():
    timings = {}
    with trace.recording(syncs=False) as rec:
        with trace.span("traverse", k=33) as trv:
            t0 = trace.now()
            t1 = trace.lap(timings, "paths_s", t0, torch.device("cpu"), "traverse.stitch.",
                           states=8, paths=2)
            trace.lap(None, "strings_s", t1, torch.device("cpu"), "traverse.stitch.")
    laps = by_name(rec)
    paths, strings = laps["traverse.stitch.paths"][0], laps["traverse.stitch.strings"][0]
    assert (paths.t0, paths.t1, strings.t0) == (t0, t1, t1)
    assert paths.parent == trv.id and paths.attrs == {"k": 33}
    assert paths.counters == {"states": 8, "paths": 2} and strings.counters == {}
    assert timings == {"paths_s": pytest.approx((t1 - t0) / 1e9)}


def test_iterate_times_each_next():
    def slow():
        for i in range(3):
            yield i

    with trace.recording(syncs=False) as rec:
        with trace.span("count", k=21):
            assert list(trace.iterate("count.pack", slow())) == [0, 1, 2]
    # three items and the call that found the end
    assert [s.name for s in rec] == ["count.pack"] * 4 + ["count"]
    assert all(s.attrs == {"k": 21} for s in rec)


# -- a whole run --------------------------------------------------------------

SPANS = [
    "job", "ingest", "ingest.parse", "ingest.pairs", "ingest.merge", "ingest.pack", "round",
    "count", "count.pack", "count.reads", "count.collapse", "count.contigs", "count.finalize",
    "finalize.fold", "finalize.cuts", "finalize.ctg_rules", "traverse", "traverse.edges",
    *(f"traverse.stitch.{s}" for s in ("pack", "repair", "cycles", "paths", "path_map",
                                       "render", "fetch", "strings")),
    "traverse.contigs", "write_fasta",
]


@pytest.fixture(scope="module")
def fastq(tmp_path_factory):
    rng = np.random.default_rng(17)
    genome = random_genome(rng, 3000)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=20.0, read_len=80, err_rate=0.002,
                                      insert_mean=120)
    path = str(tmp_path_factory.mktemp("trace") / "reads.fastq")
    write_fastq(path, ids, seqs, quals)
    return path


def _run(fastq, out, *extra):
    return run_pipeline(parse_args(["-r", fastq, "-k", "21", "33", "-o", str(out), "--device",
                                    "cpu", "--block-reads", "256", *extra]))


def _small_store(monkeypatch):
    """Budgets that make a tiny run collapse its raw runs and fold and
    apply the contig rules by key range."""
    monkeypatch.setattr(kmer_store.KmerCountStore, "RANGED_FOLD_MIN_ROWS", 2000)
    monkeypatch.setattr(kmer_store.KmerCountStore, "RANGED_FOLD_TARGET_ROWS", 3000)
    monkeypatch.setattr(kmer_store.KmerCountStore, "__init__", functools.partialmethod(
        kmer_store.KmerCountStore.__init__, raw_budget_bytes=1 << 17))


def test_run_pipeline_spans_and_the_timings_they_feed(fastq, tmp_path, monkeypatch):
    plain = _run(fastq, tmp_path / "plain")
    _small_store(monkeypatch)
    with trace.recording() as rec:
        asm = _run(fastq, tmp_path / "traced")
    final = [open(tmp_path / d / "final_assembly.fasta").read() for d in ("plain", "traced")]
    assert final[0] == final[1] and final[0].count(">") >= 1
    assert plain.round_stats.keys() == asm.round_stats.keys() == {21, 33}
    assert "read_pass_s" not in asm.round_stats[21]
    spans = by_name(rec)
    assert [n for n in SPANS if n not in spans] == []
    assert len(spans["job"]) == 1 and {s.job for s in rec} == {spans["job"][0].id}
    assert asm.round_stats[33]["collapses"] > 0 and asm.round_stats[33]["read_pieces"] > 0
    assert asm.round_stats[33]["ctg_pieces"] > 0
    # every span inside a round carries its k; none outside does
    rounds = {s.id: s.attrs["k"] for s in spans["round"]}
    assert sorted(rounds.values()) == [21, 33]
    for s in rec:
        up = s
        while up.parent and up.id not in rounds:
            up = next(p for p in rec if p.id == up.parent)
        assert s.attrs.get("k") == rounds.get(up.id), s.name
    for k in (21, 33):
        count, trav = (next(s for s in spans[n] if s.attrs["k"] == k) for n in ("count",
                                                                               "traverse"))
        assert asm.round_stats[k]["count_s"] == count.seconds
        assert asm.round_stats[k]["traverse_s"] == trav.seconds
    log = open(tmp_path / "traced" / "mhm2_torch.log").read()
    merge_s = float(re.search(r"\[module\] merge_reads ([0-9.]+)s", log).group(1))
    assert merge_s == round(spans["ingest"][0].seconds, 3)
    assert re.search(r"\[module\] merge_reads [0-9]+\.[0-9]{3}s", log)
    rows = trace.summary(rec)
    assert rows["ingest.parse"]["bytes"] == os.path.getsize(fastq)
    assert rows["ingest.parse"]["reads"] == len(asm.packed_reads) + rows["ingest.merge"]["merged"]
    assert rows["ingest.merge"]["pairs"] == rows["ingest.parse"]["reads"] // 2
    assert rows["ingest.merge"]["merged"] > 0
    assert rows["count.reads"]["raw_rows"] == sum(r["raw_rows"] for r in asm.round_stats.values())
    assert rows["count.reads"]["h2d_bytes"] > 0 and rows["count.contigs"]["h2d_bytes"] > 0
    # the cuts come back alone: R runs x (Q + 1) int64 a call
    cuts = rows["finalize.cuts"]
    assert cuts["parts"] >= 2 * cuts["calls"] and cuts["ranges"] >= 2 * cuts["calls"]
    assert 0 < cuts["d2h_bytes"] <= 8 * cuts["parts"] * (cuts["ranges"] + cuts["calls"])
    assert rows["traverse.stitch.paths"]["paths_kept"] == sum(
        r["contigs"] for r in asm.round_stats.values())
    # the layers' children sit in their layer
    parent = {s.id: s.name for s in rec}
    for child, up in (("ingest.parse", "ingest"), ("count.pack", "count"),
                      ("count.finalize", "count"), ("finalize.cuts", "count.finalize"),
                      ("traverse.stitch.render", "traverse"), ("write_fasta", "round")):
        assert parent[spans[child][0].parent] == up, child


def test_count_blocks_built_in_the_first_round_only(fastq, tmp_path, monkeypatch):
    """A three-round ladder builds its counting blocks in the first round's
    `count.pack` spans and serves every later round's from them; its
    contigs equal those of the ladder fed PackedReads.blocks() as numpy
    arrays, the stores' other input path."""
    from mhm2_proxy_tpu_torch.constants import QUAL_CUTOFF
    from mhm2_proxy_tpu_torch.models import assembler

    ks = ("21", "33", "55")
    with trace.recording(syncs=False) as rec:
        asm = _run(fastq, tmp_path / "cached", "-k", *ks)
    packs: dict = {}
    for s in by_name(rec)["count.pack"]:
        packs.setdefault(s.attrs["k"], []).append(s.counters)
    assert sorted(packs) == [21, 33, 55]
    n_blocks = asm.round_stats[21]["blocks"]
    assert n_blocks >= 2 and {r["blocks"] for r in asm.round_stats.values()} == {n_blocks}
    built = [sum(c.get("built_bytes", 0) for c in packs[k]) for k in (21, 33, 55)]
    reused = [sum(c.get("reused_blocks", 0) for c in packs[k]) for k in (21, 33, 55)]
    assert built[0] > 0 and built[1:] == [0, 0]
    assert reused == [0, n_blocks, n_blocks]

    def numpy_blocks(self, store, B, L, k):
        cut = self.cfg.qual_offset + QUAL_CUTOFF
        for codes, quals, lens in self.packed_reads.blocks(B, pad_len=L, min_len=k):
            yield codes, quals >= cut, lens

    monkeypatch.setattr(assembler.Assembler, "_read_blocks", numpy_blocks)
    plain = _run(fastq, tmp_path / "numpy", "-k", *ks)
    for name in [f"contigs-{k}.fasta" for k in ks] + ["final_assembly.fasta"]:
        got, want = (open(tmp_path / d / name).read() for d in ("cached", "numpy"))
        assert got == want and got.count(">") >= 1, name
    assert plain.round_stats.keys() == asm.round_stats.keys()
    for k, st in asm.round_stats.items():
        assert (st["kmers"], st["raw_rows"]) == (plain.round_stats[k]["kmers"],
                                                 plain.round_stats[k]["raw_rows"])


def test_stitch_stage_seconds_only_while_recording(fastq, tmp_path, monkeypatch):
    """The untraced path passes no timings dict to the stitch, so none of its
    stages syncs the device; the `stitch {...}` line keeps its counts."""
    from mhm2_proxy_tpu_torch.dbjg import stitch

    seen = []
    orig = stitch.stitch_paths

    def spy(*a, timings=None, **kw):
        seen.append(timings)
        return orig(*a, timings=timings, **kw)

    monkeypatch.setattr(stitch, "stitch_paths", spy)
    _run(fastq, tmp_path / "off")
    with trace.recording():
        _run(fastq, tmp_path / "on")
    assert seen[:2] == [None, None] and all(t for t in seen[2:]) and len(seen) == 4
    for d, staged in (("off", False), ("on", True)):
        lines = re.findall(r"k=\d+: stitch (\{.*\})", open(tmp_path / d / "mhm2_torch.log").read())
        assert len(lines) == 2
        for line in lines:
            got = eval(line)  # a dict's repr
            assert got["states"] > 0 and got["paths_kept"] > 0 and got["fetched_bytes"] > 0
            assert ("pack_s" in got) == ("strings_s" in got) == staged


def test_profile_logs_the_trace_table(fastq, tmp_path):
    out = tmp_path / "prof"
    _run(fastq, out, "--profile")
    assert not trace.is_recording()
    log = open(out / "mhm2_torch.log").read()
    table = re.findall(r"\[trace\] (\S+) +(\d+) +([0-9.]+) +([0-9.]+) +(\d+)", log)
    names = [row[0] for row in table]
    assert names[0] == "job" and set(SPANS) - set(names) == {"count.collapse", "finalize.cuts"}
    assert len(names) == len(set(names))
    rows = {row[0]: row for row in table}
    assert rows["round"][1] == "2" and float(rows["job"][2]) >= float(rows["round"][2])
    # the profiled round's spans are ranges in the profiler's trace (the
    # stitch's stage laps close before they are known: not ranges)
    prof = open(out / "profile" / "trace.json").read()
    assert all(f'"{n}"' in prof for n in ("round", "count.pack", "count.reads", "count.finalize",
                                           "traverse.edges", "traverse.contigs"))


def test_exchange_spans_hold_every_byte_sent(fastq, tmp_path):
    """Two ranks over gloo at --hosts 2 --shards 4 while a trace records:
    every byte sent to the other rank is counted on a `count.exchange` or a
    `traverse.exchange` span, so that their `sent_bytes` add up to the sum
    over every span of the job, and every collective but four sits on one
    of them; the all-to-alls' `alltoall_bytes` are a part of each span's
    bytes. A span `outside` around the whole run witnesses that nothing is
    sent outside the job's own spans, where no span would count it."""
    import json

    import torch.multiprocessing as mp

    from tests.test_torch_multiprocess import free_port
    from torch_common import traced_rank

    argv = ["-r", fastq, "-k", "21", "33", "-o", str(tmp_path / "two"), "--device", "cpu",
            "--block-reads", "64", "--hosts", "2", "--shards", "4"]
    out = str(tmp_path / "rank")
    mp.spawn(traced_rank, args=(2, free_port(), argv, out), nprocs=2, join=True)
    for r in range(2):
        got = json.load(open(f"{out}{r}.json"))
        spans = got["spans"]
        cx, tx = spans["count.exchange"], spans["traverse.exchange"]
        assert spans["outside"]["calls"] == 1
        assert spans["outside"]["sent_bytes"] == 0 and spans["outside"]["collectives"] == 0
        assert cx["sent_bytes"] > 0 and tx["sent_bytes"] > 0 and cx["records"] > 0
        assert cx["sent_bytes"] + tx["sent_bytes"] == sum(row["sent_bytes"]
                                                          for row in spans.values())
        assert 0 < cx["alltoall_bytes"] <= cx["sent_bytes"]
        assert 0 < tx["alltoall_bytes"] <= tx["sent_bytes"]
        elsewhere = {n: row["collectives"] for n, row in spans.items()
                     if n not in ("count.exchange", "traverse.exchange") and row["collectives"]}
        # outside the exchange: the three [module] lines' min / avg / max and
        # the read-id check, which send no bytes
        assert elsewhere == {"job": 3, "ingest": 1}, elsewhere


@pytest.mark.parametrize("extra", [(), ("--hosts", "2", "--shards", "4")])
def test_untraced_world_of_one_adds_no_sync(fastq, tmp_path, monkeypatch, extra):
    """Without a recording, a world of one (the single-device path, and the
    sharded one on one device) never synchronizes the device for the
    exchange's spans, which it opens all the same."""
    cuda = FakeCuda(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    _run(fastq, tmp_path / "off", *extra)
    assert cuda.syncs == 0 and cuda.modes == []
    with trace.recording(syncs=False) as rec:
        _run(fastq, tmp_path / "on", *extra)
    assert cuda.syncs == 0
    names = {s.name for s in rec}
    assert ("count.exchange" in names) == ("traverse.exchange" in names) == bool(extra)
