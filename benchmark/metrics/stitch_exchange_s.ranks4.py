"""Rank 0's cross-rank traffic of the sharded traversal in one assembly:
the program's `traverse.exchange` spans (the collectives of the edges'
lookups, the stitch's doubling rounds and the gather of the rendered
contigs), summed over the job and averaged over the window's assemblies."""

from benchmark.lib.program_trace import hook, job_spans, seconds
from benchmark.lib.records import mean


def hooks():
    return hook()


def read(rec):
    return mean(seconds(j, "traverse.exchange") for j in job_spans(rec))
