"""The sort kernel's share of its roofline over the window's assemblies:
the least time of every metered mhm2_merge call (its rows' bytes over the
HBM rate, benchmark/lib/roofline.py::merge_bytes) over the calls' measured
device time (a CUDA event pair around each call of the C entry)."""

from benchmark.lib.roofline import bytes_roofline_pct, merge_bytes


def read(rec):
    calls = [(a, s) for e, a, s in rec["meter"] if e == "mhm2_merge"]
    if not calls:
        return None
    return bytes_roofline_pct(sum(merge_bytes(a) for a, _ in calls), sum(s for _, s in calls))
