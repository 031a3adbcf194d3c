"""Background memory tracker (reference upcxx-utils mem_profile.cpp:74-143)
and free-memory probes for the count store's budgets.

Samples free host memory from /proc/meminfo on a thread and logs swings
larger than a threshold to a tracker file, like the reference's
MemoryTrackerThread. Device memory comes from torch.cuda.mem_get_info.
"""

from __future__ import annotations

import threading
import time

import torch


def get_free_mem_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def get_free_device_mem_bytes(device) -> int:
    """Free bytes on `device` (a CUDA device), 0 for the CPU.

    The memory that bounds the counting pipeline on a GPU is device memory,
    not host RAM (the reference sizes its GPU hash table from device memory
    the same way, kcount_gpu.cpp:175-196)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    free, _total = torch.cuda.mem_get_info(device)
    return int(free)


class MemoryTracker:
    def __init__(self, log_path: str, interval_s: float = 2.0, swing_bytes: int = 1 << 30):
        self.log_path = log_path
        self.interval_s = interval_s
        self.swing_bytes = swing_bytes
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self):
        last = get_free_mem_bytes()
        with open(self.log_path, "a") as f:
            f.write(f"{time.time():.1f} start free={last}\n")
            f.flush()
            while not self._stop.wait(self.interval_s):
                cur = get_free_mem_bytes()
                if abs(cur - last) >= self.swing_bytes:
                    f.write(f"{time.time():.1f} free={cur} delta={cur - last}\n")
                    f.flush()
                    last = cur
            f.write(f"{time.time():.1f} stop free={get_free_mem_bytes()}\n")

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
