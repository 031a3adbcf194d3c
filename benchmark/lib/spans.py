"""Host spans around the calls into the program's layers.

A span is (name, start ns, end ns, depth) on time.monotonic_ns. The
harness wraps a few functions of the program for the traced assembly only,
restores them afterwards, and names each idle stretch of the device by the
innermost span the host was in.
"""

from __future__ import annotations

import contextlib
import functools
import time


class SpanRecorder:
    def __init__(self):
        self.spans: list[tuple[str, int, int, int]] = []
        self._depth = 0

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.monotonic_ns()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            self.spans.append((name, t0, time.monotonic_ns(), self._depth))

    def wrap(self, owner, attr: str, name: str):
        """Replace owner.attr by a spanned call; returns an undo function."""
        orig = getattr(owner, attr)

        @functools.wraps(orig)
        def spanned(*a, **kw):
            with self.span(name):
                return orig(*a, **kw)

        setattr(owner, attr, spanned)
        return lambda: setattr(owner, attr, orig)


@contextlib.contextmanager
def wrapped(recorder: SpanRecorder, targets):
    """targets: (owner, attribute, span name) triples, wrapped for the block."""
    undo = [recorder.wrap(o, a, n) for o, a, n in targets]
    try:
        yield recorder
    finally:
        for u in reversed(undo):
            u()
