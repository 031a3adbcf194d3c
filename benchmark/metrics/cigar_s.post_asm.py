"""CIGARs of one post-assembly pass (ops/ssw.py::sw_cigar_batch): the
traceback DP, walk and rendering timings (`tb_dp_s + tb_walk_s +
cigar_render_s`) of post_asm_align, averaged over the unprofiled passes."""

from benchmark.lib.records import mean, timing, untraced_jobs


def _cigar(job):
    parts = [timing(job, k) for k in ("tb_dp_s", "tb_walk_s", "cigar_render_s")]
    return None if None in parts else sum(parts)


def read(rec):
    return mean(_cigar(j) for j in untraced_jobs(rec))
