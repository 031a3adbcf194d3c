"""FASTQ reading and parsing of one assembly: the program's `ingest.parse`
spans (each block's production by io/stream.py and the native parser, the
consumer's next()), summed over the job and averaged over the window's
assemblies."""

from benchmark.lib.program_trace import hook, job_spans, seconds
from benchmark.lib.records import mean


def hooks():
    return hook()


def read(rec):
    return mean(seconds(j, "ingest.parse") for j in job_spans(rec))
