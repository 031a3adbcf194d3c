"""Launcher / supervisor (reference src/mhm2.py).

The reference's Python launcher wraps the UPC++ job: it streams output,
classifies crashes from stderr (OOM / signal signatures, mhm2.py:305-404),
and with --auto-resume re-executes with --restart when at least one
contigging round completed (mhm2.py:585-597). This is the same supervisor
for the PyTorch pipeline: the child is `python -m mhm2_proxy_tpu_torch ...`; round
completion is detected from contigs-<k>.fasta checkpoints; resume is bounded
by --max-retries.

Fault injection for tests: MHM2_TPU_TEST_CRASH_ROUND=<k> makes the pipeline
SIGKILL itself right after round k completes (the reference has no injection
hooks; its CI relied on real crashes).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys

# stderr signatures the reference greps for (mhm2.py:305-404)
_OOM_MARKERS = (
    "Out of memory",
    "MemoryError",
    "RESOURCE_EXHAUSTED",
    "oom-kill",
    "Cannot allocate memory",
    "std::bad_alloc",
    "CUDA out of memory",
    "OutOfMemoryError",
)


def detect_scheduler_env(env=None) -> dict | None:
    """Fill multi-process rendezvous vars from scheduler env.

    The reference launcher detects SLURM/LSF/PBS/Cobalt and derives process
    counts from them (mhm2.py:107-250). Here the analogous job is mapping the
    scheduler's rank/size vars onto the MHM2_TPU_{NUM_PROCS,PROC_ID,
    COORDINATOR} rendezvous trio that main.py feeds to torch.distributed.
    Returns the derived vars (explicit MHM2_TPU_* always wins), or None when
    no scheduler context (or a 1-task job) is present.
    """
    env = os.environ if env is None else env
    if env.get("MHM2_TPU_NUM_PROCS"):
        return None  # explicit config wins
    rank = size = None
    coord_host = None
    if env.get("SLURM_PROCID") is not None and env.get("SLURM_NTASKS"):
        rank, size = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        coord_host = env.get("SLURM_LAUNCH_NODE_IPADDR")
    elif env.get("OMPI_COMM_WORLD_RANK") is not None and env.get("OMPI_COMM_WORLD_SIZE"):
        rank, size = int(env["OMPI_COMM_WORLD_RANK"]), int(env["OMPI_COMM_WORLD_SIZE"])
    elif env.get("PMI_RANK") is not None and env.get("PMI_SIZE"):
        # PMI covers PBS/Cobalt MPI launches and Cray aprun
        rank, size = int(env["PMI_RANK"]), int(env["PMI_SIZE"])
    elif env.get("LSF_PM_TASKID") is not None and env.get("LSF_PM_NUMPROCS"):
        # LSF task geometry is 1-based
        rank, size = int(env["LSF_PM_TASKID"]) - 1, int(env["LSF_PM_NUMPROCS"])
    if rank is None or size is None or size < 2:
        return None
    coord = env.get("MHM2_TPU_COORDINATOR")
    if not coord:
        port = env.get("MHM2_TPU_PORT", "8476")
        coord = f"{coord_host}:{port}" if coord_host else f"127.0.0.1:{port}"
    return {
        "MHM2_TPU_NUM_PROCS": str(size),
        "MHM2_TPU_PROC_ID": str(rank),
        "MHM2_TPU_COORDINATOR": coord,
    }


def classify_failure(output: str, returncode: int) -> str:
    """Human-readable crash class (reference stderr classification)."""
    if returncode is not None and returncode < 0:
        try:
            name = signal.Signals(-returncode).name
        except ValueError:
            name = "?"
        return f"killed by signal {-returncode} ({name})"
    for marker in _OOM_MARKERS:
        if marker in output:
            return "out of memory"
    for line in reversed(output.strip().splitlines()):
        if "Error" in line or "Exception" in line:
            return f"exception: {line.strip()[:200]}"
    return f"exit code {returncode}"


def rounds_completed(out_dir: str, kmer_lens) -> int:
    """Completed contigging rounds = existing per-round checkpoints."""
    return sum(
        os.path.exists(os.path.join(out_dir, f"contigs-{k}.fasta")) for k in kmer_lens
    )


def supervise(argv: list[str] | None = None, max_retries: int = 3) -> int:
    """Run the pipeline under supervision with auto-resume.

    Matches reference semantics: resume only if >= 1 round completed
    (mhm2.py:585-597); bounded retries; the same output dir is pinned so
    --restart finds the checkpoints.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--max-retries" in argv:
        i = argv.index("--max-retries")
        max_retries = int(argv[i + 1])
        del argv[i : i + 2]

    from .options import parse_args, setup_output_dir

    opts = parse_args(argv)
    out_dir = setup_output_dir(opts)
    if "-o" not in argv and "--output" not in argv:
        argv += ["-o", out_dir]

    attempt = 0
    while True:
        proc = subprocess.run(
            [sys.executable, "-m", "mhm2_proxy_tpu_torch", *argv],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        sys.stdout.write(proc.stdout)
        if proc.returncode == 0:
            return 0
        reason = classify_failure(proc.stdout, proc.returncode)
        done = rounds_completed(out_dir, opts.kmer_lens)
        attempt += 1
        if done < 1:
            print(f"[launcher] failed before any completed round ({reason}); not resuming")
            return proc.returncode
        if attempt > max_retries:
            print(f"[launcher] giving up after {max_retries} resume attempts ({reason})")
            return proc.returncode
        print(
            f"[launcher] run failed ({reason}) with {done} completed round(s); "
            f"auto-resuming with --restart (attempt {attempt}/{max_retries})"
        )
        if "--restart" not in argv:
            argv.append("--restart")


def main(argv=None) -> int:
    return supervise(argv)


if __name__ == "__main__":
    sys.exit(main())
