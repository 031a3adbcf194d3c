"""The bytes one rank sent to the others in an assembly, from the program's
own counters: each collective counts `sent_bytes` on the innermost span
(`parallel/comm.py`), so a job's sum over its spans is every byte it sent.
A tree whose collectives count nothing reads None."""

from __future__ import annotations

from benchmark.lib.program_trace import job_spans
from benchmark.lib.records import mean


def sent_bytes(rec: dict, counter: str = "sent_bytes"):
    """The window jobs' mean of the bytes sent (`counter`: every
    collective's, or `alltoall_bytes`, the all-to-alls' alone), or None
    without counters."""
    return mean(sum(row.get(counter, 0) for row in j.values()) for j in job_spans(rec)
                if any(counter in row for row in j.values()))
