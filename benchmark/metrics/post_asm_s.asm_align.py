"""The post-assembly alignment's share of one job, in seconds: the
program's `post_asm` span (main's `--post-asm-align --post-asm-abundance`
step: the contig index, every block's alignment and CIGARs, the SAM and the
depth table), averaged over the window's jobs."""

from benchmark.lib.program_trace import hook, job_spans, seconds
from benchmark.lib.records import mean


def hooks():
    return hook()


def read(rec):
    return mean(seconds(j, "post_asm") for j in job_spans(rec))
