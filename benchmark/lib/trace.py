"""The device's busy and idle time over one job, from torch.profiler.

The profiler records CUDA activity only (kernels, copies, sets), never the
host's operators, so a whole assembly stays a bounded trace. Busy time is
the union of those intervals inside the job's window; idle is the rest.
A 0.2 ms spin kernel launched right after a synchronize at the window's
start ties the profiler's clock to time.monotonic_ns, so that each idle
stretch is named by the host span it falls in.
"""

from __future__ import annotations

import time

import numpy as np
import torch

MARKER_CYCLES = 400_000


def _device_events(prof):
    """[(name, start ns, end ns)] of the device's activity in the profile."""
    out = []
    res = getattr(prof.profiler, "kineto_results", None)
    if res is not None:
        for ev in res.events():
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                s = int(ev.start_ns())
                out.append((ev.name(), s, s + int(ev.duration_ns())))
    return out


class DeviceTrace:
    """Profile the block; afterwards busy_s, window_s, idle by span and the
    device operations that took most time."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_mark = time.monotonic_ns()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        self.t0 = time.monotonic_ns()
        return self

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1 = time.monotonic_ns()
        self.prof.__exit__(*exc)
        self.events = _device_events(self.prof)
        del self.prof
        self.read_s = (time.monotonic_ns() - self.t1) / 1e9

    def summary(self, spans) -> dict | None:
        """busy_s, window_s, idle seconds by innermost host span, and the
        device seconds of each operation name; None without device events."""
        ev = self.events
        marks = [s for name, s, _ in ev if "spin" in name.lower() or "sleep" in name.lower()]
        if not ev or not marks:
            return None
        offset = max(marks) - self.t_mark  # this session's marker is the newest
        w0, w1 = self.t0 + offset, self.t1 + offset
        st = np.array([s for _, s, _ in ev], np.int64)
        en = np.array([e for _, _, e in ev], np.int64)
        keep = (en > w0) & (st < w1)
        st, en = np.clip(st[keep], w0, w1), np.clip(en[keep], w0, w1)
        per_op: dict[str, float] = {}
        for n, d in zip((n for (n, _, _), k in zip(ev, keep) if k), (en - st).tolist()):
            per_op[n] = per_op.get(n, 0.0) + d / 1e9
        order = np.argsort(st, kind="stable")
        st, en = st[order], en[order]
        # union of the intervals: a new run starts where every earlier end lies before
        run_end = np.maximum.accumulate(en)
        new = np.ones(st.shape[0], bool)
        new[1:] = st[1:] > run_end[:-1]
        starts = st[new]
        ends = np.append(run_end[np.nonzero(new)[0][1:] - 1], run_end[-1]) if st.size else en
        busy = int((ends - starts).sum())
        gap_lo = np.concatenate([[w0], ends])
        gap_hi = np.concatenate([starts, [w1]])
        g = gap_hi > gap_lo
        gap_lo, gap_hi = gap_lo[g], gap_hi[g]
        idle_by_span = _name_gaps(gap_lo, gap_hi, spans, offset)
        return dict(busy_s=busy / 1e9, window_s=self.seconds,
                    idle_by_span=idle_by_span, device_ops=per_op)


def _name_gaps(lo, hi, spans, offset) -> dict[str, float]:
    """Idle seconds by the innermost host span holding each gap's midpoint
    ("outside spans" for none)."""
    out: dict[str, float] = {}
    if lo.size == 0:
        return out
    mid = (lo + hi) // 2
    length = (hi - lo) / 1e9
    best = np.full(mid.shape[0], -1, np.int64)
    best_d = np.zeros(mid.shape[0], np.int64)
    for i, (_, s_lo, s_hi, depth) in enumerate(spans):
        inside = (mid >= s_lo + offset) & (mid < s_hi + offset) & (depth + 1 > best_d)
        best[inside] = i
        best_d[inside] = depth + 1
    for i in np.unique(best):
        name = spans[i][0] if i >= 0 else "outside spans"
        out[name] = out.get(name, 0.0) + float(length[best == i].sum())
    return out
