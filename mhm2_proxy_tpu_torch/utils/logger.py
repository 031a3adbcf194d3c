"""Logging (reference upcxx-utils log.hpp SLOG/LOG macro family).

Rank-0 console + per-run log file; verbosity mirrors SLOG vs SLOG_VERBOSE.
Multi-process runs additionally fan out a DEBUG-level per-process log under
`per_rank/<rank//1000:08d>/<rank:08d>/` (the reference's get_rank_path
convention, upcxx-utils/src/log.cpp:281-313) — the main triage tool when one
rank of a distributed run misbehaves. Only rank 0 writes the main log file
and the console stream.
"""

from __future__ import annotations

import logging
import os
import sys

_logger = None

MAX_RANKS_PER_DIR = 1000


def get_rank_path(fname: str, rank: int) -> str:
    """Rank-based sibling path: dir/per_rank/<rank//1000>/<rank>/name
    (reference upcxx-utils/src/log.cpp:281-313)."""
    d, base = os.path.split(fname)
    sub = os.path.join(
        d, "per_rank", f"{rank // MAX_RANKS_PER_DIR:08d}", f"{rank:08d}"
    )
    os.makedirs(sub, exist_ok=True)
    return os.path.join(sub, base)


def _rank_and_world() -> tuple[int, int]:
    """Process rank/count WITHOUT importing jax (the logger must work before
    distributed init): the launcher/scheduler env is authoritative."""
    try:
        rank = int(os.environ.get("MHM2_TPU_PROC_ID", "0"))
        world = int(os.environ.get("MHM2_TPU_NUM_PROCS", "1"))
    except ValueError:
        rank, world = 0, 1
    return rank, world


def get_logger(log_file: str | None = None, verbose: bool = False):
    global _logger
    rank, world = _rank_and_world()
    if _logger is None:
        _logger = logging.getLogger("mhm2_proxy_tpu_torch")
        _logger.setLevel(logging.DEBUG)
        if rank == 0:
            h = logging.StreamHandler(sys.stdout)
            h.setLevel(logging.DEBUG if verbose else logging.INFO)
            h.setFormatter(logging.Formatter("%(asctime)s %(message)s", "%H:%M:%S"))
            _logger.addHandler(h)
    if log_file:
        # a new run in the same process logs to its own output dir
        for h in [h for h in _logger.handlers if isinstance(h, logging.FileHandler)]:
            if h.baseFilename != os.path.abspath(log_file):
                _logger.removeHandler(h)
                h.close()
    if log_file and not any(isinstance(h, logging.FileHandler) for h in _logger.handlers):
        fmt = logging.Formatter("%(asctime)s %(message)s")
        if rank == 0:
            fh = logging.FileHandler(log_file)
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(fmt)
            _logger.addHandler(fh)
        if world > 1:
            # per-process debug log for EVERY rank (rank 0 writes both)
            rh = logging.FileHandler(get_rank_path(log_file, rank))
            rh.setLevel(logging.DEBUG)
            rh.setFormatter(fmt)
            _logger.addHandler(rh)
    return _logger


def SLOG(*args):
    get_logger().info(" ".join(str(a) for a in args))
