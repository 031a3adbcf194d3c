"""CUDA event pairs around every call of a hand kernel's C entry point.

A copy of the repository's `chip_smoke.py::launch_meter`: while the block
runs, `mhm2_proxy_tpu_torch.ops.kernels.lib()` returns a proxy each of whose
C entries records an event right before and right after the call. A pair
spans what the stream ran between its records (the entry's launches), and
none of the Python wrapper's own host work. Each call keeps its arguments
(sizes, device pointers and host arrays of them, never a tensor), so that a
metric reader can count the bytes or operations of the call from them
afterwards and pick its kernel's calls by the entry's name.
"""

from __future__ import annotations

import torch


class LaunchMeter:
    def __init__(self):
        self.calls: list[tuple[str, tuple, torch.cuda.Event, torch.cuda.Event]] = []
        self._kernels = None

    def __enter__(self):
        from mhm2_proxy_tpu_torch.ops import kernels

        lib, calls = kernels.lib(), self.calls

        class MeteredLib:
            def __getattr__(self, entry):
                fn = getattr(lib, entry)
                if entry.startswith("_"):  # the library object's own attributes
                    return fn

                def call(*args):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    rc = fn(*args)
                    e1.record()
                    calls.append((entry, args, e0, e1))
                    return rc

                return call

        metered = MeteredLib()
        self._kernels, self._orig = kernels, kernels.lib
        kernels.lib = lambda: metered
        return self

    def __exit__(self, *exc):
        self._kernels.lib = self._orig

    def timed_calls(self):
        """[(entry, args, device seconds)] after a synchronize."""
        torch.cuda.synchronize()
        return [(entry, args, e0.elapsed_time(e1) / 1e3) for entry, args, e0, e1 in self.calls]
