"""Spans and counters of the program's layers, on one monotonic clock.

    with trace.span("count", k=21) as sp:
        ...
        trace.count("raw_rows", n)      # onto the innermost open span
    sp.seconds

Every span takes its start and end on time.monotonic_ns, recorded or not:
the layers' own log lines and `Assembler.round_stats` read them. While no
`recording()` is open a span is only those two clock reads. While one is
open, each finished span is kept with its parent, its job (the outermost
span it was opened in: `run_pipeline`'s `job`), its attributes (merged
over its parents', so a round's `k` reaches every span inside the round)
and its counters; on a CUDA card each blocking synchronisation of the
device (every `.item()`, `int()`, `.cpu()`, `.tolist()`, pageable copy and
`nonzero`) adds one to the innermost span's `syncs`, through
torch.cuda.set_sync_debug_mode("warn"), whose warnings are counted, not
printed. `profiler_ranges()` makes every span also a
torch.profiler.record_function range, for the profiled round of
`--profile`; `table()` renders the recorded spans by name for its log.
"""

from __future__ import annotations

import contextlib
import itertools
import time
import warnings

import torch

now = time.monotonic_ns

SYNC_MESSAGE = "called a synchronizing CUDA operation"


class _State:
    depth = 0  # open recording() entries
    spans: list = []  # the finished spans of the outermost open recording
    stack: list = []  # the open recorded spans, innermost last
    ids = itertools.count(1)
    ranges = False  # profiler_ranges() is open
    syncs = None  # the installed _SyncCounter


class Span:
    """One interval of the program. `seconds` after it has closed; while
    recording, `id`, `parent` and `job` (span ids, 0 for none), `attrs` and
    `counters` as well."""

    __slots__ = ("name", "attrs", "t0", "t1", "id", "parent", "job", "counters", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = 0
        self._rf = None

    def __enter__(self):
        if _State.depth:
            self._open()
        if _State.ranges:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        self.t1 = now()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self.id:
            stack = _State.stack
            if stack and stack[-1] is self:
                stack.pop()
                _State.spans.append(self)
        return False

    def _open(self):
        stack = _State.stack
        up = stack[-1] if stack else None
        self.id = next(_State.ids)
        self.parent = up.id if up else 0
        self.job = up.job if up else self.id
        if up is not None and up.attrs:
            self.attrs = {**up.attrs, **self.attrs}
        self.counters = {}
        stack.append(self)

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


def span(name: str, **attrs) -> Span:
    """A context manager over one interval; it yields the span."""
    return Span(name, attrs)


def iterate(name: str, iterable):
    """The items of `iterable`, each one's production (the consumer's
    next()) inside a span `name`."""
    it = iter(iterable)
    end = object()
    while True:
        with Span(name, {}):
            item = next(it, end)
        if item is end:
            return
        yield item


def count(name: str, n: int = 1) -> None:
    """Add n to the innermost open span's counter `name` (only while
    recording)."""
    if _State.stack:
        c = _State.stack[-1].counters
        c[name] = c.get(name, 0) + n


def is_recording() -> bool:
    return _State.depth > 0


@contextlib.contextmanager
def recording(syncs: bool = True):
    """Keep every span that closes inside the block, in the list it yields
    (in the order the spans closed). Entries nest and are counted: the
    outermost one starts the list that all of them yield and ends the
    recording. With syncs, on a CUDA card, the device's blocking
    synchronisations are counted (see the module's note); the debug mode
    and the warning filters are restored when the outermost entry exits."""
    if _State.depth == 0:
        _State.spans, _State.stack = [], []
    _State.depth += 1
    if syncs and _State.syncs is None and torch.cuda.is_available():
        _State.syncs = _SyncCounter()
    try:
        yield _State.spans
    finally:
        _State.depth -= 1
        if _State.depth == 0:
            _State.stack = []
            if _State.syncs is not None:
                _State.syncs.close()
                _State.syncs = None


class _SyncCounter:
    """set_sync_debug_mode("warn") with its warnings turned into `syncs`
    counts on the innermost span."""

    def __init__(self):
        self._mode = torch.cuda.get_sync_debug_mode()
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        self._show = warnings.showwarning
        warnings.showwarning = self._show_or_count
        torch.cuda.set_sync_debug_mode("warn")

    def _show_or_count(self, message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_MESSAGE):
            count("syncs")
        else:
            self._show(message, category, filename, lineno, file, line)

    def close(self):
        torch.cuda.set_sync_debug_mode(self._mode)
        self._catch.__exit__(None, None, None)


@contextlib.contextmanager
def profiler_ranges():
    """Every span opened in the block is also a
    torch.profiler.record_function range of its name."""
    before, _State.ranges = _State.ranges, True
    try:
        yield
    finally:
        _State.ranges = before


def lap(timings, key: str, t0: int, dev, prefix: str = "", **counters) -> int:
    """The stage `key` from t0 (a now() reading) to now: with a timings
    dict, after a synchronize of the device's queued work, its seconds
    added to timings[key]; while recording, a span `prefix + key` (without
    its `_s`) holding `counters`, closed already. Returns the new start."""
    if timings is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = now()
    if timings is not None:
        timings[key] = timings.get(key, 0.0) + (t1 - t0) / 1e9
    if _State.depth:
        sp = Span(prefix + key.removesuffix("_s"), {})
        sp._open()
        _State.stack.pop()
        sp.t0, sp.t1 = t0, t1
        sp.counters.update(counters)
        if timings is not None and dev.type == "cuda":
            sp.counters["syncs"] = 1
        _State.spans.append(sp)
    return t1


def summary(spans, job: int | None = None) -> dict:
    """{name: {"calls", "seconds", "self_seconds", counters...}} over the
    spans (of one job, if given), in the order the names first opened; a
    span's self seconds are its own less those of its direct children."""
    spans = sorted((s for s in spans if job is None or s.job == job), key=lambda s: s.t0)
    child_ns: dict[int, int] = {}
    for s in spans:
        child_ns[s.parent] = child_ns.get(s.parent, 0) + (s.t1 - s.t0)
    out: dict[str, dict] = {}
    for s in spans:
        row = out.setdefault(s.name, {"calls": 0, "seconds": 0.0, "self_seconds": 0.0})
        row["calls"] += 1
        row["seconds"] += s.seconds
        row["self_seconds"] += (s.t1 - s.t0 - child_ns.get(s.id, 0)) / 1e9
        for c, v in s.counters.items():
            row[c] = row.get(c, 0) + v
    return out


def table(spans, job: int | None = None) -> list[str]:
    """The `[trace]` lines: one row a span name, its calls, seconds, self
    seconds, syncs and other counters."""
    rows = summary(spans, job)
    lines = [f"[trace] {'span':<24} {'calls':>6} {'seconds':>10} {'self_s':>10} {'syncs':>7}"
             "  counters"]
    for name, r in rows.items():
        extra = ", ".join(f"{c} {v}" for c, v in r.items()
                          if c not in ("calls", "seconds", "self_seconds", "syncs"))
        lines.append(f"[trace] {name:<24} {r['calls']:>6} {r['seconds']:>10.3f} "
                     f"{r['self_seconds']:>10.3f} {r.get('syncs', 0):>7}  {extra}".rstrip())
    return lines
