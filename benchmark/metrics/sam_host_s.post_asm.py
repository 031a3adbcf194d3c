"""Post-assembly output on the host (post_asm.py::sam_block and the depth
sums): post_asm_align's `host_s` timing, averaged over the unprofiled
passes."""

from benchmark.lib.records import mean, timing, untraced_jobs


def read(rec):
    return mean(timing(j, "host_s") for j in untraced_jobs(rec))
