"""What rank 0 sent to the other ranks in one assembly, in GB: the
program's `sent_bytes` counters summed over every span of the job (the
k-mer exchange, the traversal's lookups and stitch, the contigs' gather),
averaged over the window's assemblies."""

from benchmark.lib.exchange import sent_bytes
from benchmark.lib.program_trace import hook


def hooks():
    return hook()


def read(rec):
    b = sent_bytes(rec)
    return None if b is None else b / 1e9
