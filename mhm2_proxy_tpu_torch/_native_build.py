"""The one way the port builds native code (imports neither torch nor the
ops package).

A library is keyed by a hash of its sources and flags, under
`mhm2_proxy_tpu_torch/_build/<hash>/`; one whose hash is new is built under
a temporary name, with its commands and their output in `build.log` beside
it, and renamed into place, so a process never loads a half-written one,
and processes that build it at once each load a whole one. A hash-keyed
library cannot be stale. Two libraries go through it: the CUDA kernels of
ops/_build.py and the host library of io/native.py.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def source_hash(sources, flags) -> str:
    """A build directory's name: a hash of the flags and of each source's
    name and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def run(cmd) -> tuple[str, str | None]:
    """One build command: (its line and output, for build.log; the output
    again if it failed, else None)."""
    res = subprocess.run(cmd, capture_output=True, text=True)
    out = res.stdout + res.stderr
    return " ".join(map(str, cmd)) + "\n" + out, out if res.returncode else None


def build_library(name: str, sources, flags, compile) -> tuple[Path, float | None]:
    """The library `name` of these sources and flags, built first if its
    hash is new: compile(tmp) builds it at the path tmp and returns (the
    build's log, its error or None). Returns (the library's path, the
    build's wall seconds, or None where it was built already). A failed
    build raises RuntimeError, naming its build.log."""
    so = BUILD_DIR / source_hash(sources, flags) / name
    if so.exists():
        return so, None
    so.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp{so.suffix}")
    try:
        log, err = compile(tmp)
        (so.parent / "build.log").write_text(log)
        if err is not None:
            raise RuntimeError(f"building {so} failed (see {so.parent / 'build.log'}):\n"
                               f"{err[-4000:]}")
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
    return so, time.perf_counter() - t0
