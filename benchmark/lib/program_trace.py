"""The program's own spans over the traced window.

hook() records the spans of mhm2_proxy_tpu_torch/utils/trace.py while the
window's jobs run, with the device's blocking synchronisations counted on
each span (`syncs`). Its result() sums them by name for each job (a
`run_pipeline`, whose root span is `job`), in the order the jobs ran:
{"program_spans": [{name: {"calls", "seconds", counter: total}}, ...]}.
Recordings nest and count their entries, so several metrics' hooks record
once. A tree without the tracer records nothing: result() is {} and the
readers read None.
"""

from __future__ import annotations


class ProgramSpans:
    def __init__(self):
        self._cm = self._spans = None

    def __enter__(self):
        try:
            from mhm2_proxy_tpu_torch.utils import trace
        except ImportError:
            return self
        self._cm = trace.recording(syncs=True)
        self._spans = self._cm.__enter__()
        return self

    def __exit__(self, *exc):
        if self._cm is not None:
            self._cm.__exit__(*exc)
        return False

    def result(self) -> dict:
        if self._spans is None:
            return {}
        jobs: dict[int, dict] = {}
        roots = {s.id for s in self._spans if s.name == "job" and s.id == s.job}
        for s in self._spans:
            if s.job not in roots:
                continue
            row = jobs.setdefault(s.job, {}).setdefault(s.name, {"calls": 0, "seconds": 0.0})
            row["calls"] += 1
            row["seconds"] += (s.t1 - s.t0) / 1e9
            for name, v in s.counters.items():
                row[name] = row.get(name, 0) + v
        return {"program_spans": [jobs[j] for j in sorted(jobs)]}


def hook() -> ProgramSpans:
    return ProgramSpans()


def job_spans(rec: dict) -> list[dict]:
    """The summed spans of each window job (none without the tracer)."""
    return rec.get("program_spans") or []


def seconds(job: dict, name: str):
    """The seconds of span `name` summed over the job, None if it never ran."""
    row = job.get(name)
    return row["seconds"] if row else None


def counter(job: dict, name: str) -> int:
    """Counter `name` summed over every span of the job."""
    return sum(row.get(name, 0) for row in job.values())
