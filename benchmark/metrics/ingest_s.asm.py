"""Host ingest and pair merge of one assembly: the program's
`[module] merge_reads` log line (io/stream.py, io/merge.py, native/),
averaged over the window's unprofiled assemblies."""

from benchmark.lib.records import mean, module_seconds, untraced_jobs


def read(rec):
    return mean(module_seconds(j["log"], "merge_reads") for j in untraced_jobs(rec))
