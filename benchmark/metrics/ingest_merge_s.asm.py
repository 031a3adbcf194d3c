"""The pair merge of one assembly: the program's `ingest.merge` spans
(io/merge.py::merge_reads_arrays, the native merge), summed over the job
and averaged over the window's assemblies."""

from benchmark.lib.program_trace import hook, job_spans, seconds
from benchmark.lib.records import mean


def hooks():
    return hook()


def read(rec):
    return mean(seconds(j, "ingest.merge") for j in job_spans(rec))
