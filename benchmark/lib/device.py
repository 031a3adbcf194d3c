"""The card a run measures: presence, name, power limit, memory peaks.

A measurement needs CUDA cards; without them a run stops with a non-zero
exit and no result (there is no CPU fallback). The CPU path exists only for
the benchmark's own tests, which call the harness with require_chip=False.
"""

from __future__ import annotations

import subprocess

import torch

GB = 1e9


class NoChip(RuntimeError):
    """The run asked for more cards than this machine has."""


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is False: the benchmark measures CUDA cards only")
    have = torch.cuda.device_count()
    if have < n:
        raise NoChip(f"the cell needs {n} CUDA cards, torch.cuda.device_count() is {have}")


def describe(device: torch.device, count: int) -> dict:
    """The result line's device entry (peak filled in by the caller)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count}


def card_line() -> str:
    """nvidia-smi's name and power limit of the cards, for the log."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


class PeakTracker:
    """The largest torch.cuda.max_memory_allocated over a stretch of work in
    which the program resets the peak itself (each contigging round does):
    each reset first reads the peak it is about to clear."""

    def __init__(self, device: torch.device):
        self.device = device
        self.peak = 0
        self._orig = None

    def __enter__(self):
        if self.device.type != "cuda":
            return self
        torch.cuda.reset_peak_memory_stats(self.device)
        orig = self._orig = torch.cuda.reset_peak_memory_stats

        def reset(device=None):
            self.read()
            orig(device)

        torch.cuda.reset_peak_memory_stats = reset
        return self

    def read(self) -> int:
        if self.device.type == "cuda":
            self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.device))
        return self.peak

    def __exit__(self, *exc):
        if self._orig is not None:
            self.read()
            torch.cuda.reset_peak_memory_stats = self._orig
            self._orig = None
