"""Seeding and alignment of one post-assembly pass (ops/lookup.py,
ops/ssw.py::sw_align): post_asm_align's `align_s` timing, averaged over the
window's unprofiled passes."""

from benchmark.lib.records import mean, timing, untraced_jobs


def read(rec):
    return mean(timing(j, "align_s") for j in untraced_jobs(rec))
