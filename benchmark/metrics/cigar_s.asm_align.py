"""CIGARs of one job's reads (ops/ssw.py::sw_cigar_batch): the program's
`post_asm.tb_dp`, `post_asm.tb_walk` and `post_asm.cigar_render` spans (the
traceback DP, its walk and the rendering, each ending at a sync), summed
over the job and averaged over the window's jobs."""

from benchmark.lib.program_trace import hook, job_spans, seconds
from benchmark.lib.records import mean

SPANS = ("post_asm.tb_dp", "post_asm.tb_walk", "post_asm.cigar_render")


def hooks():
    return hook()


def _cigar(job):
    parts = [seconds(job, name) for name in SPANS]
    return None if None in parts else sum(parts)


def read(rec):
    return mean(_cigar(j) for j in job_spans(rec))
