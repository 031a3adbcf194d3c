"""Blocking synchronisations of the host with the device in one assembly:
the program's `syncs` counters summed over every span of the job (each
synchronizing CUDA operation that torch.cuda.set_sync_debug_mode("warn")
reports, and each device sync of a timed stage), averaged over the
window's assemblies."""

from benchmark.lib.program_trace import counter, hook, job_spans
from benchmark.lib.records import mean


def hooks():
    return hook()


def read(rec):
    return mean(counter(j, "syncs") for j in job_spans(rec))
