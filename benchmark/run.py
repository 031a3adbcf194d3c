"""The benchmark of mhm2_proxy_tpu_torch on CUDA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's file, `benchmark/workloads/
<cell>.json`, names its configuration (`benchmark/configs/<config>.json`)
and traffic kind (`benchmark/traffic/<kind>.py`); `BENCHMARK.json` names the
metrics, and each per-layer metric is read by `benchmark/metrics/<name>.py`.

A run: set-up (the kernels loaded or built, the community made from the
seed, the traffic's warm-up; `setup_s`), then a closed loop of whole jobs
started while less than --seconds has passed, the last one run to its
end, then the check of every job's output against the plain reference.
--trace 1 meters the hand kernels' calls in the window, then profiles the
device over one more job, and prints the per-layer metrics instead of the
end-to-end ones. The last line of standard output is one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "mhm2_proxy_tpu")


class Context:
    """What one run's traffic sees: its cell, configuration, seed, device,
    scratch directory and the state its set-up leaves for the jobs."""

    def __init__(self, workload: dict, config: dict, seed: int, device, tmp: str):
        self.workload, self.config, self.seed = workload, config, seed
        self.device, self.tmp = device, tmp
        self.state: dict = {}


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, kind: str) -> list[dict]:
    """The cell's end_to_end or per_layer metrics: those without a
    `workloads` list, and those that list the cell."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def metric_module(name: str):
    """benchmark/metrics/<name>.py: its read(rec) -> number or None, and
    optionally hooks() -> a context manager that the traced window runs
    inside, whose result() -> dict is added to the record (for counts that
    the kernel meter's arguments do not carry)."""
    import importlib.util

    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark.metrics." + name.replace(".", "__"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    return metric_module(name).read


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             require_chip: bool = True, config: dict | None = None,
             params: dict | None = None, check_fn=None, workload: dict | None = None) -> dict:
    """One run of a cell; returns the result object. config and params
    replace the cell's configuration and traffic parameters (the tests run
    tiny communities on the CPU with require_chip=False); check_fn replaces
    the traffic's check (the control); workload replaces the cell's file
    (the tests run traffic kinds that no cell uses yet)."""
    import torch

    from benchmark.lib import device as devlib

    wl = workload or load_json("workloads", f"{cell}.json")
    if require_chip:
        devlib.require_cards(int(wl["chips"]))
    cfg = config or load_json("configs", f"{wl['config']}.json")
    if params:
        wl = dict(wl, params=dict(wl["params"], **params))
    dev = torch.device(device)
    spec = benchmark_spec()
    traffic = importlib.import_module(f"benchmark.traffic.{wl['traffic']}")
    tmp = tempfile.mkdtemp(prefix="mhm2bench-")
    try:
        return _run(cell, wl, cfg, spec, traffic, seed, seconds, trace, dev, tmp, check_fn)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(cell, wl, cfg, spec, traffic, seed, seconds, trace, dev, tmp, check_fn):
    import torch

    from benchmark.lib import device as devlib

    ctx = Context(wl, cfg, seed, dev, tmp)
    t_lib = time.perf_counter()
    if dev.type == "cuda":
        from mhm2_proxy_tpu_torch.io import native
        from mhm2_proxy_tpu_torch.ops import _build

        _build.load()
        native.merge_available()
    t_traffic = time.perf_counter()
    traffic.setup(ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    setup_s = t_end - T_START
    print(f"set-up {setup_s:.2f}s: start and imports {t_lib - T_START:.2f}s, kernel and native "
          f"libraries {t_traffic - t_lib:.2f}s, the traffic's set-up {t_end - t_traffic:.2f}s "
          f"({', '.join(f'{k} {v:.2f}s' for k, v in ctx.state.get('setup_parts', {}).items())})",
          file=sys.stderr, flush=True)
    rec = dict(jobs=[], traced_job=None, trace=None, meter=[], int32_ops_per_s=None)
    jobs = rec["jobs"]
    hooks = []
    if trace:
        mods = [metric_module(m["name"]) for m in cell_metrics(spec, cell, "per_layer")]
        hooks = [m.hooks for m in mods if hasattr(m, "hooks")]
    with devlib.PeakTracker(dev) as peaks:
        wall = _window(ctx, traffic, seconds, trace and dev.type == "cuda", rec, hooks)
    peak = peaks.peak
    e2e = dict(traffic.end_to_end(ctx, jobs, wall), setup_s=setup_s,
               peak_mem_GB=peak / devlib.GB)
    metrics, breakdown = {}, None
    if trace:
        for m in cell_metrics(spec, cell, "per_layer"):
            v = metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = _breakdown(rec["trace"])
    else:
        for m in cell_metrics(spec, cell, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    if dev.type == "cuda":  # the program's cached blocks go before the reference runs
        torch.cuda.empty_cache()
    checks, failed = (check_fn or traffic.check)(ctx, jobs)
    correct = not failed and all(v <= lim for v, lim in checks.values())
    device = devlib.describe(dev, int(wl["chips"]))
    device["memory_peak_bytes"] = int(peak)
    if trace and rec["trace"] is not None:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
    out = {"correct": bool(correct), "attempted": len(jobs), "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()}
    return out


def _window(ctx, traffic, seconds: float, trace: bool, rec: dict, hooks=()) -> float:
    """Whole jobs back to back, each started while less than `seconds` has
    passed; returns the window's wall. With trace, every call of a hand
    kernel's C entry is metered and the metrics' hooks run around the
    window's jobs, and one more job then runs under the profiler with
    host spans around the layers, after the window: jobs that follow a
    profiled one run their launch-bound parts slower (PERF.md, section 6).
    The readings go into rec."""
    import contextlib

    import torch

    jobs = rec["jobs"]
    with contextlib.ExitStack() as stack:
        meter, counters = None, []
        if trace:
            from benchmark.lib.meter import LaunchMeter

            meter = stack.enter_context(LaunchMeter())
            counters = [stack.enter_context(h()) for h in hooks]
        w0 = t_job = time.perf_counter()
        while not jobs or t_job - w0 < seconds:
            jobs.append(traffic.job(ctx, len(jobs)))
            t_end = time.perf_counter()
            print(_job_line(len(jobs) - 1, t_end - t_job, jobs[-1]), file=sys.stderr, flush=True)
            t_job = t_end
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - w0
    if trace:
        from benchmark.lib.roofline import int32_ops_per_s
        from benchmark.lib.spans import SpanRecorder, wrapped
        from benchmark.lib.trace import DeviceTrace

        rec["meter"] = meter.timed_calls()
        for c in counters:
            rec.update(c.result())
        rec["int32_ops_per_s"] = int32_ops_per_s(ctx.device.index or 0)
        spans = SpanRecorder()
        with wrapped(spans, traffic.span_targets()), DeviceTrace() as tracer:
            jobs.append(traffic.job(ctx, len(jobs)))
        rec["traced_job"] = len(jobs) - 1
        print(_job_line(len(jobs) - 1, tracer.seconds, jobs[-1]) + f" (profiled; "
              f"{len(tracer.events)} device events read in {tracer.read_s:.1f}s)",
              file=sys.stderr, flush=True)
        rec["trace"] = tracer.summary(spans.spans)
    return wall


def _job_line(i: int, secs: float, job: dict) -> str:
    """One job's wall and the program's own timings of it, for the log."""
    from benchmark.lib.records import round_sum

    parts = [f"job {i}: {secs:.3f}s"]
    parts += [f"{k} {v:.3f}s" for k, v in (job.get("timings") or {}).items() if k.endswith("_s")]
    if job.get("round_stats"):
        parts += [f"{k} {round_sum(job, k):.3f}s" for k in ("count_s", "traverse_s")]
    return ", ".join(parts)


def short_op_name(name: str) -> str:
    """A device operation's name without its return type, template and
    argument lists: `void at::native::f<...>(...)` -> `at::native::f`;
    names without a C++ scope (copies, sets) stay as they are."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    elif "::" not in name:
        return name
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def _breakdown(tr) -> dict | None:
    if not tr:
        return None
    ops: dict[str, float] = {}
    for n, sec in tr["device_ops"].items():
        ops[short_op_name(n)] = ops.get(short_op_name(n), 0.0) + sec
    top = lambda d: [[n, s] for n, s in sorted(d.items(), key=lambda x: -x[1])[:10]]  # noqa: E731
    return {"device_ops": top(ops), "idle_gaps": top(tr["idle_by_span"])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from benchmark.lib.device import NoChip, card_line

    try:
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except NoChip as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(f"benchmark: card {card_line()}", file=sys.stderr)
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
