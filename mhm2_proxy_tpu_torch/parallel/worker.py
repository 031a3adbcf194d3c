"""One process (one host) of a multi-process run, end to end.

    python -m mhm2_proxy_tpu_torch.parallel.worker PID N PORT FASTQ OUTDIR
        [--device cpu|cuda] [--local-shards D] [--block-reads B] [--bucket-cap C]

Start N of them, PID 0 .. N-1, with the same PORT (a free TCP port on this
machine: the process group's rendezvous, tcp://localhost:PORT). The flow is
the reference's multi-node run: per-rank byte-range FASTQ ingest
(fastq.cpp:399-455; a two-file 'f1:f2' input is split at a common pair
boundary, merged and given disjoint read ids), k = 21 counting through the
hierarchical two-stage exchange over an (N, D) layout
(three_tier_aggr_store.hpp:289-316), the sharded traversal, and the
N-ranks-one-file FASTA write (ofstream.cpp:113-202). A single-file input is
read as unpaired reads, as the reference's worker reads it. Every rank ends
with the same global contig list.

OUTDIR receives final_assembly.fasta (written by all ranks together,
'>Contig<i> <depth>' records of the sorted contigs), contigs-<PID>.json
(that list), worker-<PID>.json (the rank's counting and traversal walls, the
bytes and seconds of its cross-rank transport, its peak device memory, its
exchange statistics, its kernels' launch counts, its shard tables' row
count and a digest of each one's live rows),
mhm2_torch.log (rank 0) and per_rank/<...>/mhm2_torch.log (every rank).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

K = 21
QUAL_OFFSET = 33


def parse_args(argv):
    p = argparse.ArgumentParser(prog="mhm2_proxy_tpu_torch.parallel.worker")
    p.add_argument("pid", type=int)
    p.add_argument("n_procs", type=int)
    p.add_argument("port", type=int)
    p.add_argument("fastq", help="an interleaved FASTQ, or 'f1:f2'")
    p.add_argument("outdir")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--local-shards", type=int, default=2, help="shards a process (D)")
    p.add_argument("--block-reads", type=int, default=64, help="reads a process's block")
    p.add_argument("--bucket-cap", type=int, default=8192,
                   help="exchange bucket rows in k-mers (0: sized from the block)")
    return p.parse_args(argv)


def count_reads(counter, fastq: str, rank: int, n_ranks: int, block_reads: int,
                device="cuda") -> int:
    """This rank's share of the reads through counter, in blocks of
    block_reads rows of a width and a count that every rank agrees on.
    Returns the rank's read count. With rank 0 of 1 it reads the whole
    input (a single-process control)."""
    from ..constants import QUAL_CUTOFF
    from ..models.assembler import Assembler, AssemblerConfig, _lists_to_block
    from . import comm
    from .multihost import check_read_id_disjointness

    B = block_reads
    if ":" in fastq:
        # two-file pairs: byte ranges aligned to a common pair boundary
        # (fastq.cpp:310-396), the pair merge and read ids
        asm = Assembler(AssemblerConfig(kmer_lens=(K,), block_reads=B, device=str(device)))
        asm.load_reads([fastq], rank=rank, n_ranks=n_ranks)
        # the reference's cross-rank read-id disjointness check
        # (merge_reads.cpp:542-570)
        check_read_id_disjointness(asm.packed_reads.id_span())
        reads = asm.packed_reads
        max_len, n_local = comm.all_max(reads.max_read_len, len(reads))
        L = (max_len + 31) // 32 * 32
        blocks = reads.blocks(B, pad_len=L, min_len=K)
        n_reads = len(reads)
    else:
        from ..io.fastq import FastqReader

        rdr = FastqReader(fastq, rank=rank, n_ranks=n_ranks)
        n_reads = len(rdr.seqs)
        max_len, n_local = comm.all_max(max((len(s) for s in rdr.seqs), default=1), n_reads)
        L = max(96, (max_len + 31) // 32 * 32)  # 96 covers the test reads

        def lists():
            for b in range(0, n_reads, B):
                codes, q, lens = _lists_to_block(rdr.seqs[b : b + B], rdr.quals[b : b + B], 32,
                                                 QUAL_OFFSET, rows=B)
                pad = ((0, 0), (0, L - codes.shape[1]))
                yield (np.pad(codes, pad, constant_values=4),
                       np.pad(q, pad, constant_values=QUAL_OFFSET), lens)

        blocks = lists()
    n_blocks = (n_local + B - 1) // B
    for b in range(n_blocks):
        blk = next(blocks, None)
        if blk is None:  # this rank ran out first: empty rows
            blk = (np.full((B, L), 4, np.uint8), np.zeros((B, L), np.uint8),
                   np.zeros((B,), np.int32))
        codes, q, lens = blk
        counter.add_reads_block(codes, q >= QUAL_OFFSET + QUAL_CUTOFF, lens)
    return n_reads


def shard_digests(table) -> list:
    """(live rows, sha256 of each local shard's live words, count, left and
    right bytes), by local shard."""
    out = []
    for s, n in enumerate(table.n.tolist()):
        h = hashlib.sha256()
        for x in (table.words[s, :n], table.count[s, :n], table.left[s, :n], table.right[s, :n]):
            h.update(x.cpu().numpy().tobytes())
        out.append([n, h.hexdigest()])
    return out


def fasta_records(contigs, first: int = 0) -> bytes:
    """'>Contig<i> <depth>' records of contigs, numbered from first."""
    return b"".join(f">Contig{first + i} {d:.6f}\n{s}\n".encode()
                    for i, (s, d) in enumerate(contigs))


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    pid, n_procs = args.pid, args.n_procs
    # the logger keys its per-rank fan-out (utils/logger.py, reference
    # log.cpp:281-313) off these, as a launcher exports them
    os.environ["MHM2_TPU_PROC_ID"] = str(pid)
    os.environ["MHM2_TPU_NUM_PROCS"] = str(n_procs)
    from ..dbjg import traverse_debruijn_graph_sharded
    from ..ops import kernels
    from ..utils.logger import get_logger
    from . import comm
    from .multihost import HierarchicalCounter, init_multihost, write_fasta_multihost

    os.makedirs(args.outdir, exist_ok=True)
    log = get_logger(log_file=os.path.join(args.outdir, "mhm2_torch.log"))
    dev = init_multihost(f"localhost:{args.port}", n_procs, pid, device=args.device)
    D = args.local_shards
    log.info(f"worker {pid}/{n_procs} up: layout ({n_procs}, {D}) on {dev}")
    log.debug(f"worker {pid}: per-rank debug stream")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    comm.reset_transport()
    comm.meter_transport(True)  # the report's transport seconds
    kernels.reset_launches()

    t0 = time.perf_counter()
    counter = HierarchicalCounter(K, (n_procs, D), bucket_cap=args.bucket_cap or None,
                                  device=dev)
    n_reads = count_reads(counter, args.fastq, pid, n_procs, args.block_reads, dev)
    if counter.dropped:
        raise RuntimeError(f"{counter.dropped} records dropped")
    table = counter.finalize()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    count_transport = dict(comm.TRANSPORT)
    t1 = time.perf_counter()
    stats: dict = {}
    contigs = sorted(traverse_debruijn_graph_sharded(table, K, stats=stats))
    t2 = time.perf_counter()

    # coordinated one-file output: each rank renders a contiguous slice
    per = (len(contigs) + n_procs - 1) // n_procs
    payload = fasta_records(contigs[pid * per : (pid + 1) * per], pid * per)
    write_fasta_multihost(os.path.join(args.outdir, "final_assembly.fasta"), payload, pid,
                          n_procs)
    with open(os.path.join(args.outdir, f"contigs-{pid}.json"), "w") as f:
        json.dump([[s, d] for s, d in contigs], f)
    report = dict(
        pid=pid, n_procs=n_procs, device=str(dev), reads=n_reads, contigs=len(contigs),
        count_s=t1 - t0, traverse_s=t2 - t1,
        count_transport=count_transport,
        transport={key: comm.TRANSPORT[key] - count_transport[key] for key in count_transport},
        peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
        exchange=counter.describe_exchange(), spill_rounds=counter.spill_rounds,
        stitch_rounds=stats["stitch_rounds"], shards=shard_digests(table),
        rows=int(table.words.shape[1]), launches=kernels.launches(),
    )
    with open(os.path.join(args.outdir, f"worker-{pid}.json"), "w") as f:
        json.dump(report, f)
    log.info(f"worker {pid}: counting {report['count_s']:.2f}s, traversal "
             f"{report['traverse_s']:.2f}s, transport {report['count_transport']} then "
             f"{report['transport']}, exchange {report['exchange']}")
    print(f"worker {pid} ok: {n_reads} reads, {len(contigs)} contigs", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
