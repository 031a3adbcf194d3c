"""k-mer counting of one assembly: the program's per-round `count_s`
(Assembler.round_stats, the span of each round's `counted ... in Xs` line,
which ends at a device sync), summed over the rounds and averaged over the
window's unprofiled assemblies."""

from benchmark.lib.records import mean, round_sum, untraced_jobs


def read(rec):
    return mean(round_sum(j, "count_s") for j in untraced_jobs(rec))
