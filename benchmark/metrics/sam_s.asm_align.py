"""The SAM file and the depth table of one job, on the host: the program's
`post_asm.sam` spans (the header, each block's sums, SAM lines and their
write, and the depth table), summed over the job and averaged over the
window's jobs."""

from benchmark.lib.program_trace import hook, job_spans, seconds
from benchmark.lib.records import mean


def hooks():
    return hook()


def read(rec):
    return mean(seconds(j, "post_asm.sam") for j in job_spans(rec))
