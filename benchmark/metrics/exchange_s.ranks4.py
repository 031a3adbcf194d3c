"""Rank 0's k-mer exchange in one assembly: the program's `count.exchange`
spans (each collective of the read and contig k-mer exchange, spill rounds
included, with the bucketing before it; the device drained before and
after while the trace records), summed over the job and averaged over the
window's assemblies."""

from benchmark.lib.program_trace import hook, job_spans, seconds
from benchmark.lib.records import mean


def hooks():
    return hook()


def read(rec):
    return mean(seconds(j, "count.exchange") for j in job_spans(rec))
