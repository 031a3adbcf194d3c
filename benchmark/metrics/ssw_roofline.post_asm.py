"""The ssw kernel's share of its roofline over the window's passes: the DP
cells of every call (query length x window length summed over its pairs,
from the length tensors it was handed) x 7.5 integer operations, over the
card's int32 rate (SMs x 64 lanes x the SM clock's maximum), over the calls'
device time (a CUDA event pair around each call of the C entry). Only the
operations bound ssw: its bytes are a few hundred per pair.

The C entry's arguments carry device pointers, not the lengths, so hooks()
counts the cells where the wrapper hands the length tensors to the kernel."""

import torch

from benchmark.lib.roofline import SSW_OPS_PER_CELL


class SswCells:
    """The length tensors of every ssw kernel call in the traced window;
    result() sums each call's cells once the window has closed."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from mhm2_proxy_tpu_torch.ops import ssw

        self._mod, self._orig = ssw, ssw._sw_ends_cuda
        calls, orig = self.calls, self._orig

        def metered(query, q_len, ref, r_len, *a, **kw):
            calls.append((q_len, r_len))
            return orig(query, q_len, ref, r_len, *a, **kw)

        ssw._sw_ends_cuda = metered
        return self

    def __exit__(self, *exc):
        self._mod._sw_ends_cuda = self._orig

    def result(self) -> dict:
        return {"ssw_cells": [int((q.to(torch.int64) * r.to(torch.int64)).sum())
                              for q, r in self.calls]}


def hooks():
    return SswCells()


def read(rec):
    secs = [s for e, _a, s in rec["meter"] if e == "mhm2_ssw"]
    cells = rec.get("ssw_cells") or []
    if not secs or len(secs) != len(cells) or not rec.get("int32_ops_per_s"):
        return None
    least = sum(cells) * SSW_OPS_PER_CELL / rec["int32_ops_per_s"]
    return 100.0 * least / sum(secs)
