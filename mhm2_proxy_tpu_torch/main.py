"""Application entry point (port of mhm2_proxy_tpu/main.py; reference src/main.cpp).

Option load, output-dir setup, config save, read merge + pack, per-k
contigging rounds with checkpoint files, final assembly dump and stats, and
the post-assembly alignment, on one torch device (default cuda; no CPU
fallback when CUDA is absent). Restart semantics follow the reference
(docs/mhm_guide.md:197-210): with --restart, the merged-reads checkpoint
replaces the pair merge and rounds whose contigs-<k>.fasta checkpoint
exists are skipped, their contigs reloaded; --contigs/--prev-kmer-len
resume after an external contig checkpoint; --post-asm-only aligns the
reads to the final_assembly.fasta already in the output directory.
--shards S counts and traverses over S shards on the one device; with
--hosts H > 1 as well, the S shards form H hosts of S / H devices and the
k-mers travel as supermers through the hierarchical two-stage exchange
(within each host, then across hosts), all on the one device. A launcher
or a scheduler that exports the rendezvous variables (MHM2_TPU_NUM_PROCS,
MHM2_TPU_PROC_ID, MHM2_TPU_COORDINATOR; launcher.detect_scheduler_env fills
them from SLURM, MPI, PBS or LSF) makes main() join a process group first
(parallel/multihost.py::init_multihost); the sharded store then spreads its
shards over the processes, each of which reads only its own byte range of
the FASTQ, and rank 0 writes the output files.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys

import torch

from .io.fasta import read_fasta
from .models.assembler import Assembler, AssemblerConfig, Contig
from .options import Options, parse_args, setup_output_dir
from .utils import trace
from .utils.logger import get_logger
from .utils.memlog import MemoryTracker


def log_module(log, name: str, secs: float):
    """[module] timing line; multi-process runs aggregate min/avg/max across
    processes (reference MinSumMax reductions, upcxx-utils/timers.hpp:42-161)."""
    from .parallel import comm

    if comm.world() > 1:
        from .parallel.multihost import min_sum_max

        s = min_sum_max(secs)
        log.info(
            f"[module] {name} {s['avg']:.3f}s "
            f"(min {s['min']:.3f} max {s['max']:.3f} over {s['n']} procs)"
        )
    else:
        log.info(f"[module] {name} {secs:.3f}s")


def _check_supported(opts: Options) -> None:
    if opts.shards < 0:
        raise ValueError(f"--shards must be >= 0, got {opts.shards}")


def load_checkpoint_contigs(fname: str) -> list[Contig]:
    out = []
    for name, seq in read_fasta(fname):
        parts = name.split()
        cid = int(parts[0].replace("Contig", "")) if parts else 0
        depth = float(parts[1]) if len(parts) > 1 else 1.0
        out.append(Contig(cid, seq, depth))
    return out


def _infer_contigs_k(fname: str) -> int:
    """k of a contigs-<k>.fasta checkpoint filename; 0 if not inferable."""
    m = re.search(r"contigs-(\d+)\.fasta(\.gz)?$", os.path.basename(fname))
    return int(m.group(1)) if m else 0


@contextlib.contextmanager
def _profiled(device, out_dir: str, log):
    """The block (one round) under torch.profiler (host and, on CUDA, device
    activity), each of the program's spans a record_function range in it;
    the trace goes to <out_dir>/profile/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof_dir = os.path.join(out_dir, "profile")
    os.makedirs(prof_dir, exist_ok=True)
    with profile(activities=acts) as prof, trace.profiler_ranges():
        yield
    prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
    log.info(f"[profile] trace written to {prof_dir}")


def run_pipeline(opts: Options) -> Assembler:
    """One run, the root span `job`. --profile records the run's spans
    (utils/trace.py) and logs their `[trace]` table at its end."""
    with trace.recording() if opts.profile else contextlib.nullcontext() as spans:
        with trace.span("job") as job:
            asm = _run(opts)
    if spans is not None:
        log = get_logger()
        for line in trace.table(spans, job.id):
            log.info(line)
    return asm


def _run(opts: Options) -> Assembler:
    _check_supported(opts)
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mhm2_torch: --device cuda but torch.cuda.is_available() is False "
                         "(no CUDA device); pass --device cpu to run the plain versions")
    out_dir = setup_output_dir(opts)
    log = get_logger(log_file=os.path.join(out_dir, "mhm2_torch.log"), verbose=opts.verbose)
    opts.save(os.path.join(out_dir, "mhm2_torch.config"))
    log.info(f"Starting mhm2_torch in {out_dir} with k={opts.kmer_lens} on {device}")
    from .parallel import comm

    if comm.active():
        import torch.distributed as dist

        log.info(f"process {comm.rank()} of {comm.world()}, backend {dist.get_backend()}")

    cfg = AssemblerConfig(
        kmer_lens=tuple(opts.kmer_lens),
        qual_offset=opts.qual_offset,
        dmin_thres=opts.min_depth_thres,
        min_ctg_print_len=opts.min_ctg_print_len,
        block_reads=opts.block_reads,
        checkpoint=opts.checkpoint,
        output_dir=out_dir,
        verbose=opts.verbose,
        dump_kmers=opts.dump_kmers,
        device=opts.device,
        n_shards=opts.shards,
        n_hosts=opts.hosts,
        bucket_cap=opts.bucket_cap or None,
    )
    asm = Assembler(cfg)
    tracker = MemoryTracker(os.path.join(out_dir, "memory_tracker.log"))
    tracker.start()
    try:
        with trace.span("ingest") as sp:
            merged_ckpt = os.path.join(out_dir, "reads-merged.fastq.gz")
            reloaded_merged = opts.restart and os.path.exists(merged_ckpt)
            if reloaded_merged:
                # the merged-reads checkpoint is already merged and holds any
                # unpaired inputs: no re-merge (docs/mhm_guide.md:197-210)
                asm.load_merged_reads(merged_ckpt)
                log.info("[restart] reloaded merged reads checkpoint")
            else:
                # each rank of a sharded multi-process run ingests its own
                # byte range, with read ids disjoint across ranks
                rank, n_ranks = asm.read_split()
                asm.load_reads(list(opts.reads), rank=rank, n_ranks=n_ranks)
                if opts.unpaired:
                    from .io.fastq import FastqReader

                    for fname in opts.unpaired:
                        r = FastqReader(fname, rank=rank, n_ranks=n_ranks)
                        asm.add_unpaired(r.seqs, r.quals)
                if asm.own_reads:
                    from .parallel.multihost import check_read_id_disjointness

                    check_read_id_disjointness(asm.packed_reads.id_span())
        log_module(log, "merge_reads", sp.seconds)
        if opts.checkpoint_merged and not reloaded_merged:
            asm.dump_merged_reads(merged_ckpt)
            log.info("[checkpoint] wrote reads-merged.fastq.gz")

        if opts.post_asm_only:
            # the existing final assembly, and only the post-assembly steps
            # (docs/mhm_guide.md:226-233)
            fa = os.path.join(out_dir, "final_assembly.fasta")
            if not os.path.exists(fa):
                raise FileNotFoundError(f"--post-asm-only needs {fa}")
            asm.contigs = load_checkpoint_contigs(fa)
            log.info(f"[post-asm-only] loaded {len(asm.contigs)} contigs from {fa}")
        prev_k = 0
        if opts.contigs and not opts.post_asm_only:
            # an external contig checkpoint is the most recent round's
            # output: rounds at or below its k are done
            # (docs/mhm_guide.md:285-309)
            asm.contigs = load_checkpoint_contigs(opts.contigs)
            prev_k = opts.prev_kmer_len or _infer_contigs_k(opts.contigs)
            if not prev_k:
                raise ValueError(
                    f"--contigs {opts.contigs}: cannot infer its k-mer round "
                    "from the filename; pass --prev-kmer-len"
                )
            log.info(
                f"[restart] loaded {len(asm.contigs)} contigs from {opts.contigs} "
                f"(previous round k={prev_k}); resuming at the first k > {prev_k}"
            )
        profiled = False
        for k in opts.kmer_lens if not opts.post_asm_only else []:
            if prev_k and k <= prev_k:
                log.info(f"[restart] skipping k={k} (<= --prev-kmer-len {prev_k})")
                continue
            ckpt = os.path.join(out_dir, f"contigs-{k}.fasta")
            if opts.restart and os.path.exists(ckpt):
                asm.contigs = load_checkpoint_contigs(ckpt)
                log.info(f"[restart] skipping k={k}, loaded {len(asm.contigs)} contigs "
                         f"from {ckpt}")
                continue
            profiling = opts.profile and not profiled
            profiled |= profiling
            with _profiled(asm.device, out_dir, log) if profiling else contextlib.nullcontext():
                with trace.span("round", k=k) as sp:
                    asm.run_round(k)
            log_module(log, f"contigging k={k}", sp.seconds)
            if os.environ.get("MHM2_TPU_TEST_CRASH_ROUND") == str(k):
                # fault injection for supervisor tests: die hard AFTER the
                # round's checkpoint is on disk (launcher.py auto-resume)
                os.kill(os.getpid(), 9)
        asm.packed_reads.release_count_blocks()

        if not opts.post_asm_only:
            asm.dump_contigs(os.path.join(out_dir, "final_assembly.fasta"))
        if opts.gfa and comm.rank() == 0:
            from .io.gfa import write_gfa2

            n_edges = write_gfa2(
                os.path.join(out_dir, "final_assembly.gfa2"),
                [(c.id, c.seq, c.depth) for c in asm.contigs
                 if len(c.seq) >= opts.min_ctg_print_len],
                max([opts.max_kmer_len] + list(opts.kmer_lens)),
            )
            log.info(f"[gfa] wrote final_assembly.gfa2 with {n_edges} edges")
        if opts.post_asm_align or opts.post_asm_abundance:
            from .models.post_asm import post_asm_align

            tm: dict = {}
            with trace.span("post_asm") as sp:
                post_asm_align(
                    asm,
                    sam_fname=os.path.join(out_dir, "final_assembly.sam")
                    if opts.post_asm_align else None,
                    abundance_fname=os.path.join(out_dir, "final_assembly_depths.tsv")
                    if opts.post_asm_abundance else None,
                    timings=tm,
                )
            log.info("post-asm-align timings: " + ", ".join(
                f"{n} {v:.2f}s" for n, v in tm.items() if n.endswith("_s")))
            log_module(log, "post_asm_align", sp.seconds)
        asm.print_stats()
        log.info("Finished")
    finally:
        tracker.stop()
    return asm


def main(argv=None):
    opts = parse_args(argv)
    # multi-process launch (reference mhm2.py builds the upcxx-run spawn,
    # src/mhm2.py:446-466): joins the process group when the launcher
    # exports the rendezvous env vars; scheduler env (SLURM/MPI/PBS/LSF,
    # mhm2.py:107-250) fills them when they are absent
    from .launcher import detect_scheduler_env

    sched = detect_scheduler_env()
    if sched:
        os.environ.update(sched)
    nprocs = os.environ.get("MHM2_TPU_NUM_PROCS")
    if nprocs:
        from .parallel.multihost import init_multihost

        init_multihost(os.environ["MHM2_TPU_COORDINATOR"], int(nprocs),
                       int(os.environ["MHM2_TPU_PROC_ID"]), device=opts.device)
    run_pipeline(opts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
