"""Readings of a run's record, shared by the per-layer metric readers.

A record holds the window's jobs (each with its log lines and the program's
per-round counters), which job ran under the profiler, the profile's
summary, and the metered kernel calls.
"""

from __future__ import annotations

import re


def untraced_jobs(rec: dict) -> list[dict]:
    """The jobs that ran without the profiler, or all of them if none did."""
    jobs = [j for i, j in enumerate(rec["jobs"]) if i != rec.get("traced_job")]
    return jobs or rec["jobs"]


def mean(values):
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def module_seconds(log: list[str], module: str):
    """The seconds of the program's `[module] <name> Xs` log line."""
    pat = re.compile(r"\[module\] " + re.escape(module) + r" ([0-9.]+)s")
    for line in log:
        m = pat.search(line)
        if m:
            return float(m.group(1))
    return None


def round_sum(job: dict, key: str):
    """A per-round counter of the program summed over the job's rounds."""
    rs = job.get("round_stats") or {}
    return sum(r[key] for r in rs.values()) if rs else None


def timing(job: dict, key: str):
    return (job.get("timings") or {}).get(key)
