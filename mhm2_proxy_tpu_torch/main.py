"""Application entry point (port of mhm2_proxy_tpu/main.py; reference src/main.cpp).

Option load, output-dir setup, config save, read merge + pack, per-k
contigging rounds with checkpoint files, final assembly dump and stats, on
one torch device (default cuda; no CPU fallback when CUDA is absent).
Restarts, post-assembly alignment, --profile and sharded runs are not ported
yet and stop with NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from .models.assembler import Assembler, AssemblerConfig
from .options import Options, parse_args, setup_output_dir
from .utils.logger import get_logger
from .utils.memlog import MemoryTracker


def _check_supported(opts: Options) -> None:
    unported = [
        (opts.restart or bool(opts.contigs), "restarts (--restart, --contigs)", 13),
        (opts.post_asm_align or opts.post_asm_abundance or opts.post_asm_only,
         "post-assembly (--post-asm-*)", 11),
        (opts.profile, "--profile", 13),
        (opts.shards > 0 or opts.hosts > 1, "sharded runs (--shards, --hosts)", 12),
    ]
    for on, what, item in unported:
        if on:
            raise NotImplementedError(f"{what} not ported yet: ROADMAP queue 1 item {item}")


def run_pipeline(opts: Options) -> Assembler:
    _check_supported(opts)
    device = torch.device(opts.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("mhm2_torch: --device cuda but torch.cuda.is_available() is False "
                         "(no CUDA device); pass --device cpu to run the plain versions")
    out_dir = setup_output_dir(opts)
    log = get_logger(log_file=os.path.join(out_dir, "mhm2_torch.log"), verbose=opts.verbose)
    opts.save(os.path.join(out_dir, "mhm2_torch.config"))
    log.info(f"Starting mhm2_torch in {out_dir} with k={opts.kmer_lens} on {device}")

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
    )
    asm = Assembler(cfg)
    tracker = MemoryTracker(os.path.join(out_dir, "memory_tracker.log"))
    tracker.start()
    try:
        t0 = time.time()
        asm.load_reads(list(opts.reads))
        if opts.unpaired:
            from .io.fastq import FastqReader

            for fname in opts.unpaired:
                r = FastqReader(fname)
                asm.add_unpaired(r.seqs, r.quals)
        log.info(f"[module] merge_reads {time.time() - t0:.2f}s")
        if opts.checkpoint_merged:
            asm.dump_merged_reads(os.path.join(out_dir, "reads-merged.fastq.gz"))
            log.info("[checkpoint] wrote reads-merged.fastq.gz")
        for k in opts.kmer_lens:
            t0 = time.time()
            asm.run_round(k)
            log.info(f"[module] contigging k={k} {time.time() - t0:.2f}s")
        asm.dump_contigs(os.path.join(out_dir, "final_assembly.fasta"))
        if opts.gfa:
            from .io.gfa import write_gfa2

            n_edges = write_gfa2(
                os.path.join(out_dir, "final_assembly.gfa2"),
                [(c.id, c.seq, c.depth) for c in asm.contigs
                 if len(c.seq) >= opts.min_ctg_print_len],
                max([opts.max_kmer_len] + list(opts.kmer_lens)),
            )
            log.info(f"[gfa] wrote final_assembly.gfa2 with {n_edges} edges")
        asm.print_stats()
        log.info("Finished")
    finally:
        tracker.stop()
    return asm


def main(argv=None):
    run_pipeline(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
