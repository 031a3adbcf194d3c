"""Seeding and alignment of one job's reads: the program's `post_asm.align`
spans (each block's seed lookup, vote, window gather and both ssw passes,
to the results' copy to the host), summed over the job and averaged over
the window's jobs."""

from benchmark.lib.program_trace import hook, job_spans, seconds
from benchmark.lib.records import mean


def hooks():
    return hook()


def read(rec):
    return mean(seconds(j, "post_asm.align") for j in job_spans(rec))
