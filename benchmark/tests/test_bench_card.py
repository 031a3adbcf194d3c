"""Runs of the harness on the card at a small size: every per-layer metric
of the cell is read, shares of a roofline stay within 100%, and the
controls come out not correct. On the card:
python -m pytest -p no:cacheprovider benchmark/tests -m chip"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests import communities

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small(name: str) -> dict:
    return communities.config(name, genomes=3, genome_len=300_000,
                              pairs=36_000 if name == "uniform2x100" else 24_000)


PARAMS = {"warmup_pairs": 4096, "warmup_reads": 4096, "check_reads": 1024, "check_longest": 32}


def _traced_run(cell: str, config: dict) -> dict:
    """A traced run in a process of its own, as the benchmark's command
    runs each: one profiler session a process."""
    code = ("import json, sys; sys.path.insert(0, %r); from benchmark import run; "
            "print(json.dumps(run.run_cell(%r, %d, 1, True, config=json.loads(%r), "
            "params=json.loads(%r))))"
            % (os.path.dirname(HERE), cell, 2**31 + 99, json.dumps(config), json.dumps(PARAMS)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in run.benchmark_spec()["workloads"]])
def test_traced_run_reads_every_layer(cuda, cell):
    spec = run.benchmark_spec()
    name = run.load_json("workloads", f"{cell}.json")["config"]
    out = _traced_run(cell, small(name))
    assert out["correct"], out["checks"]
    want = {m["name"] for m in run.cell_metrics(spec, cell, "per_layer")}
    assert set(out["metrics"]) == want
    for n, m in out["metrics"].items():
        assert m["value"] >= 0, n
        if m["unit"] == "%":
            assert m["value"] <= 100, n
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]


@pytest.mark.chip
def test_controls_are_not_correct(cuda):
    from benchmark.traffic import ladder, post_asm

    out = run.run_cell("cami_low12.ladder", 5, 0, False, config=small("cami_low12"),
                       params=PARAMS,
                       check_fn=lambda ctx, jobs: ladder.check(ctx, jobs, depth_dtype="float32"))
    assert not out["correct"] and out["checks"]["round_contigs_differing"]["value"] > 0
    # the post-asm traffic, which no cell runs yet, on the uniform test community
    wl = communities.workload("uniform2x100", "post_asm", PARAMS)
    out = run.run_cell(wl["name"], 5, 0, False, config=small("uniform2x100"), workload=wl,
                       check_fn=lambda ctx, jobs: post_asm.check(ctx, jobs, score_bits=8))
    assert not out["correct"] and out["checks"]["sam_records_wrong"]["value"] > 0
