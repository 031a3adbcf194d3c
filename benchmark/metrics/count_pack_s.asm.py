"""The host's packing of read blocks for counting in one assembly: the
program's `count.pack` spans (each block from PackedReads.blocks, its
quality mask and its rows), summed over the rounds and averaged over the
window's assemblies."""

from benchmark.lib.program_trace import hook, job_spans, seconds
from benchmark.lib.records import mean


def hooks():
    return hook()


def read(rec):
    return mean(seconds(j, "count.pack") for j in job_spans(rec))
