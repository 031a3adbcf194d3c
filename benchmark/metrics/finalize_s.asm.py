"""The count store's finalize in one assembly: the program's
`count.finalize` spans (KmerCountStore.finalize: the remainder's collapse,
the folds, the range cuts and the contig rules), summed over the rounds
and averaged over the window's assemblies."""

from benchmark.lib.program_trace import hook, job_spans, seconds
from benchmark.lib.records import mean


def hooks():
    return hook()


def read(rec):
    return mean(seconds(j, "count.finalize") for j in job_spans(rec))
