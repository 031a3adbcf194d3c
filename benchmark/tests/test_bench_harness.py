"""The harness: BENCHMARK.json against its contract, lookup by name, the
metric readers on recorded data, the JAX guard, the refusal without a card,
and runs on the CPU that see planted faults come out not correct."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_units_and_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(r) for r in c["reduced"])
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))
    assert all(0.01 <= m["bound"] <= 0.25 for m in spec["end_to_end"])
    assert 1 <= spec["run_seconds"] <= 51


def test_everything_is_found_by_name(spec):
    import importlib

    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        wl = run.load_json("workloads", f"{w['name']}.json")
        assert {k: wl[k] for k in ("name", "config", "traffic", "chips", "why")} == w
        traffic = importlib.import_module(f"benchmark.traffic.{w['traffic']}")
        for fn in ("setup", "job", "end_to_end", "check", "span_targets"):
            assert callable(getattr(traffic, fn))
    for m in spec["per_layer"]:
        assert callable(run.metric_reader(m["name"]))


def test_each_layer_metric_moves_a_metric_its_cells_report(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for cell in cells:
        reported = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert run.cell_metrics(spec, cell, "per_layer")


def _record():
    log = ["20:01:02 [module] merge_reads 4.71s", "20:01:09 k=21: counted 5 kmers in 2.1s"]
    jobs = [dict(log=log, round_stats={21: dict(count_s=2.0, traverse_s=0.5),
                                       33: dict(count_s=3.0, traverse_s=1.5)}),
            dict(log=["[module] merge_reads 5.29s"],
                 round_stats={21: dict(count_s=4.0, traverse_s=1.0)})]
    # two merges of 1,000 + 3,000 rows of 3 lanes: 2 * 4,000 * 3 * 4 bytes
    args = [(None, None, 1000, None, None, 0, None, None, 3, 2, None, 1, None),
            (None, None, 2000, None, None, 1000, None, None, 3, 2, None, 1, None)]
    meter = [("mhm2_merge", args[0], 1e-5), ("mhm2_merge", args[1], 3e-5),
             ("mhm2_extract", (), 1.0)]
    trace = dict(busy_s=1.5, window_s=6.0, idle_by_span={}, device_ops={})
    return dict(jobs=jobs, traced_job=1, trace=trace, meter=meter, int32_ops_per_s=1e13)


def test_metric_readers_on_recorded_data():
    rec = _record()
    assert run.metric_reader("ingest_s.asm")(rec) == pytest.approx(4.71)
    assert run.metric_reader("count_s.asm")(rec) == pytest.approx(5.0)
    assert run.metric_reader("traverse_s.asm")(rec) == pytest.approx(2.0)
    want = 100 * (2 * 4000 * 3 * 4 / 3.35e12) / 4e-5
    assert run.metric_reader("sort_roofline.asm")(rec) == pytest.approx(want)
    assert run.metric_reader("device_idle_pct.asm")(rec) == pytest.approx(75.0)
    rec.update(traced_job=None, trace=None, meter=[])
    assert run.metric_reader("ingest_s.asm")(rec) == pytest.approx(5.0)
    assert run.metric_reader("sort_roofline.asm")(rec) is None
    assert run.metric_reader("device_idle_pct.asm")(rec) is None


def test_trace_union_and_gap_names():
    import numpy as np

    from benchmark.lib.trace import DeviceTrace

    tr = DeviceTrace.__new__(DeviceTrace)
    tr.t_mark, tr.t0, tr.t1 = 0, 1_000, 11_000
    # the marker starts 500 ns after t_mark: the profiler's clock is 500 ahead
    tr.events = [("spin_kernel", 500, 900), ("a", 1_500, 3_500), ("b", 3_000, 4_500),
                 ("a", 7_500, 9_500)]
    spans = [("ingest", 1_000, 6_000, 0), ("count.reads", 4_000, 6_000, 1)]
    s = tr.summary(spans)
    assert s["busy_s"] == pytest.approx(5_000 / 1e9)
    assert s["window_s"] == pytest.approx(10_000 / 1e9)
    # window [1500, 11500) in the profiler's clock; gaps [4500, 7500), whose
    # middle 6000 lies in count.reads ([4500, 6500)), and [9500, 11500) outside
    assert s["idle_by_span"] == pytest.approx({"count.reads": 3e-6, "outside spans": 2e-6})
    assert s["device_ops"] == pytest.approx({"a": 4e-6, "b": 1.5e-6})
    assert np.isclose(100 * (1 - s["busy_s"] / s["window_s"]), 50.0)


def test_no_jax_after_importing_the_harness():
    code = ("import sys; sys.argv = ['run.py']; sys.path.insert(0, %r); import benchmark.run as r; "
            "import benchmark.traffic.ladder, benchmark.lib.trace, benchmark.lib.meter, "
            "benchmark.lib.spans, benchmark.lib.roofline, benchmark.lib.records; "
            "import mhm2_proxy_tpu_torch.main, mhm2_proxy_tpu_torch.models.post_asm; "
            "print(r.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "mhm2_proxy_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mhm2_proxy_tpu.fake", object())
    assert run.forbidden_modules() == ["mhm2_proxy_tpu.fake"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from benchmark.lib.device import NoChip

    with pytest.raises(NoChip):
        run.run_cell("cami_low12.ladder", 1, 1, False)
    rc = run.main(["--workload", "cami_low12.ladder", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_post_asm_readers_on_recorded_data():
    t = lambda a, dp, walk, ren, host: dict(align_s=a, tb_dp_s=dp, tb_walk_s=walk,  # noqa: E731
                                            cigar_render_s=ren, host_s=host)
    jobs = [dict(timings=t(0.6, 5.0, 4.0, 1.0, 7.0)), dict(timings=t(0.8, 6.0, 4.0, 2.0, 8.0)),
            dict(timings=t(9.0, 9.0, 9.0, 9.0, 9.0))]
    # two ssw calls of 1e9 and 3e9 cells in 2 + 2 ms; a merge call beside them
    meter = [("mhm2_ssw", (), 2e-3), ("mhm2_merge", (), 1.0), ("mhm2_ssw", (), 2e-3)]
    rec = dict(jobs=jobs, traced_job=2, trace=None, meter=meter, int32_ops_per_s=1e13,
               ssw_cells=[10**9, 3 * 10**9])
    assert run.metric_reader("align_s.post_asm")(rec) == pytest.approx(0.7)
    assert run.metric_reader("cigar_s.post_asm")(rec) == pytest.approx(11.0)
    assert run.metric_reader("sam_host_s.post_asm")(rec) == pytest.approx(7.5)
    want = 100 * (4e9 * 7.5 / 1e13) / 4e-3
    assert run.metric_reader("ssw_roofline.post_asm")(rec) == pytest.approx(want)
    rec["ssw_cells"] = [10**9]  # a call whose cells were not counted: no reading
    assert run.metric_reader("ssw_roofline.post_asm")(rec) is None


def test_a_metric_declares_its_own_counters(monkeypatch):
    """The ssw roofline's hooks() counts the cells of each call where the
    wrapper hands the length tensors to the kernel; the traffic knows
    nothing of it."""
    from mhm2_proxy_tpu_torch.ops import ssw

    monkeypatch.setattr(ssw, "_sw_ends_cuda", lambda q, ql, r, rl, *a, **kw: "ends")
    mod = run.metric_module("ssw_roofline.post_asm")
    with mod.hooks() as counter:
        assert ssw._sw_ends_cuda(None, torch.tensor([3, 4]), None, torch.tensor([5, 6])) == "ends"
    assert ssw._sw_ends_cuda(None, torch.tensor([1]), None, torch.tensor([1])) == "ends"
    assert counter.result() == {"ssw_cells": [3 * 5 + 4 * 6]}
    spec = run.benchmark_spec()
    for cell in (w["name"] for w in spec["workloads"]):
        traffic = run.load_json("workloads", f"{cell}.json")["traffic"]
        src = open(os.path.join(HERE, "traffic", f"{traffic}.py")).read()
        assert "LaunchMeter" not in src and "hooks" not in src


def test_the_meter_times_every_c_entry(monkeypatch):
    from mhm2_proxy_tpu_torch.ops import kernels

    from benchmark.lib import meter

    class Event:
        clock = [0.0]

        def __init__(self, enable_timing):
            self.t = None

        def record(self):
            Event.clock[0] += 1.0
            self.t = Event.clock[0]

        def elapsed_time(self, other):
            return 1e3 * (other.t - self.t)

    class Lib:
        _handle = 7

        def mhm2_sort(self, n, lanes):
            return 0

        def mhm2_extract(self, n):
            return 0

    monkeypatch.setattr(kernels, "lib", lambda: Lib())
    monkeypatch.setattr(meter.torch.cuda, "Event", Event)
    monkeypatch.setattr(meter.torch.cuda, "synchronize", lambda: None)
    with meter.LaunchMeter() as m:
        lib = kernels.lib()
        assert lib._handle == 7
        lib.mhm2_sort(10, 3)
        lib.mhm2_extract(5)
    assert kernels.lib().__class__ is Lib
    assert m.timed_calls() == [("mhm2_sort", (10, 3), 1.0), ("mhm2_extract", (5,), 1.0)]
