"""Traversal and stitch of one assembly: the program's per-round
`traverse_s` (Assembler.round_stats, the span of each round's
`traversal -> ... in Xs` line, which ends at a host list), summed over the
rounds and averaged over the window's unprofiled assemblies."""

from benchmark.lib.records import mean, round_sum, untraced_jobs


def read(rec):
    return mean(round_sum(j, "traverse_s") for j in untraced_jobs(rec))
