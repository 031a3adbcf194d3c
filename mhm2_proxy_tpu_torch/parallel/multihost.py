"""Multi-process execution: the process group, the hierarchical two-stage
exchange and the host utilities (port of mhm2_proxy_tpu/parallel/multihost.py).

The reference scales past one node with a node-aware ThreeTierAggrStore
(upcxx-utils/include/upcxx_utils/three_tier_aggr_store.hpp:289-316: rank
microblocks -> node-shared blocks -> one rpc per node pair -> local
fan-out) and per-host byte-range ingest (fastq.cpp:399-455). The S
shards are laid out as H hosts of D devices, S = H * D, host-major (shard =
t_host * D + t_dev). A run of H processes (init_multihost) holds one host a
process, its D shards on the process's device; a run of one process holds
all H hosts on its one device (the (H, D) layout tuple stands for the
reference's ("dcn", "ici") mesh):

  stage A: each shard's records go to the shard of its own host whose
    device index is the target's, t % D (a transpose within each host);
  combine: a presum of each shard's received rows, keyed by the target
    host (the node-shared block dedup: fewer rows cross hosts);
  stage B: each shard's rows go to the same device index of the target
    host, t // D: one all-to-all across the processes (one message per
    host pair), or a transpose across the hosts of one process. Its input
    is at most D * cap rows and its buckets hold D * cap, so it cannot
    overflow.

Stage-A leftovers come back with their global targets for spill rounds,
which run while any rank has leftovers.
The target host rides across stage A in the meta word's spare bits. The
output is a ShardedTable of S host-major shards, so the sharded lookup,
traversal and stitch run on it unchanged.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops.u32 import narrow, widen
from . import comm
from .comm import COUNT_EXCHANGE
from .sharded import RecordFns, ShardedCounter, _bucketize, _presum_duplicates

MAX_HOSTS = 256  # the target host rides in 8 spare meta bits


def _slurm_tasks_on_node(spec: str, node: int) -> int:
    """A SLURM_TASKS_PER_NODE spec ("2(x3),1") -> node's task count."""
    counts = []
    for part in spec.split(","):
        n, _, rep = part.partition("(x")
        counts += [int(n)] * (int(rep.rstrip(")")) if rep else 1)
    return counts[node]


def local_layout(process_id: int, num_processes: int, env=None) -> tuple[int, int]:
    """(this process's rank on its host, the processes on its host), from the
    launcher's or the scheduler's environment; without either, every
    process runs on this host."""
    env = os.environ if env is None else env
    for r, n in (("MHM2_TPU_LOCAL_RANK", "MHM2_TPU_LOCAL_PROCS"),
                 ("LOCAL_RANK", "LOCAL_WORLD_SIZE"),  # torchrun
                 ("OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE"),
                 ("MPI_LOCALRANKID", "MPI_LOCALNRANKS")):  # MPICH, Intel MPI
        if env.get(r) is not None and env.get(n):
            return int(env[r]), int(env[n])
    if env.get("SLURM_LOCALID") is not None and env.get("SLURM_TASKS_PER_NODE"):
        return (int(env["SLURM_LOCALID"]),
                _slurm_tasks_on_node(env["SLURM_TASKS_PER_NODE"], int(env.get("SLURM_NODEID", 0))))
    return process_id, num_processes


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   device="cuda") -> torch.device:
    """Join the run's process group (torch.distributed over TCP at
    coordinator, "host:port"; the reference launcher's role, src/mhm2.py:446-466)
    and return this rank's device.

    The backend follows from where the ranks run: gloo when the run's device
    is the CPU, or when the processes of a host (local_layout) outnumber its
    cards and so share them; nccl when each has a card of its own,
    cuda:<local rank>. NCCL refuses two ranks on one card. gloo moves CUDA
    tensors itself, through host memory."""
    dev = torch.device(device)
    local, n_local = local_layout(process_id, num_processes)
    if dev.type == "cpu":
        backend, why = "gloo", "the run's device is the CPU"
    elif torch.cuda.device_count() >= n_local:
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend, why = "nccl", f"each of this host's {n_local} ranks has a card of its own ({dev})"
    else:
        dev = torch.device("cuda", torch.cuda.current_device())
        backend, why = "gloo", (f"this host's {n_local} ranks share {torch.cuda.device_count()} "
                                "card(s); gloo stages CUDA tensors through host memory")
    kw = dict(device_id=dev) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)
    from ..utils.logger import get_logger

    get_logger().info(f"init_multihost: rank {process_id} of {num_processes} on {dev}, "
                      f"backend {backend} ({why})")
    return dev


def host_byte_ranges(file_size: int, n_hosts: int) -> list[tuple[int, int]]:
    """Even byte-range split of an input file across hosts.

    Each host then resyncs its start to the next record boundary with the
    FastqReader state machine (io/fastq.py), mirroring the reference's
    per-node offset seeking (fastq.cpp:399-455).
    """
    per = file_size // n_hosts
    return [
        (h * per, file_size if h == n_hosts - 1 else (h + 1) * per)
        for h in range(n_hosts)
    ]


def interleaved_pair_range(fname: str, rank: int, n_ranks: int) -> tuple[int, int]:
    """This rank's byte range of an interleaved FASTQ, cut only between
    pairs (the interleaved role of the reference's per-rank offset seeking,
    fastq.cpp:399-455): rank r's first record is the first mate 1 that
    starts at or after size * r / n_ranks, a record whose successor shares
    its name. A range (lo, hi) holds the records that start in (lo, hi]
    (io/stream.py's resync; 0 starts at the file's first byte), so each cut
    sits on the byte before its pair's first record. Every rank computes
    every cut alone, and neighbours agree."""
    from ..io.fastq import normalize_fq_name
    from ..io.stream import _scan_records

    size = os.path.getsize(fname)

    def cut(r: int) -> int:
        if r <= 0:
            return 0
        if r >= n_ranks:
            return size
        recs = _scan_records(fname, max(size * r // n_ranks - 1, 0))
        first, second = next(recs, None), next(recs, None)
        if first is None:
            return size
        if second is not None:
            a, b = normalize_fq_name(first[1]), normalize_fq_name(second[1])
            if a is None or b is None or a[0] != b[0]:
                first = second  # the first record found is a mate 2
        return first[0] - 1 if first[0] > 0 else 0

    lo, hi = cut(rank), cut(rank + 1)
    return lo, max(lo, hi)


def min_sum_max(value: float) -> dict:
    """Cross-process min/avg/max of a scalar (reference MinSumMax reductions,
    upcxx-utils/timers.hpp:42-161, used for per-module time balance reports).

    Single-process: degenerate (min == avg == max == value)."""
    if comm.world() <= 1:
        return dict(min=value, avg=value, max=value, n=1)
    vals = comm.all_gather_array([value], np.float64)
    return dict(
        min=float(vals.min()), avg=float(vals.mean()), max=float(vals.max()),
        n=len(vals),
    )


def check_read_id_disjointness(id_span: tuple[int, int] | None):
    """Verify no two processes assigned overlapping read-id ranges (the
    analog of the reference's neighbor-rank disjointness rpc,
    merge_reads.cpp:542-570, done as one allgather of [lo, hi] spans).

    id_span: local (min_abs_id, max_abs_id) from PackedReads.id_span(), or
    None when this process holds no identified reads. Raises on overlap.
    """
    lo, hi = id_span if id_span is not None else (-1, -1)
    spans = comm.all_gather_array([lo, hi]).reshape(-1, 2)
    live = spans[spans[:, 0] >= 0]
    order = np.argsort(live[:, 0], kind="stable")
    live = live[order]
    for a, b in zip(live[:-1], live[1:]):
        if b[0] <= a[1]:
            raise ValueError(
                f"read-id ranges overlap across processes: {a.tolist()} vs {b.tolist()}"
            )
    return len(live)


class HierarchicalCounter(ShardedCounter):
    """Sharded k-mer counting with the node-aware two-stage exchange over an
    (n_hosts, per_host) layout of the shards (the reference's
    make_host_mesh shape); supermers on by default, as the reference's."""

    def __init__(self, k: int, layout: tuple[int, int], dmin_thres: int = 2,
                 bucket_cap: int | None = None, device="cuda", use_supermers: bool = True):
        H, D = layout
        if not 1 <= H <= MAX_HOSTS:
            raise ValueError(f"{H} hosts: the target host rides in 8 meta bits (1..{MAX_HOSTS})")
        if D < 1:
            raise ValueError(f"{D} devices a host")
        if comm.world() not in (1, H):
            raise ValueError(f"{H} hosts over {comm.world()} processes: one process holds "
                             "one host, or every host")
        super().__init__(k, H * D, dmin_thres=dmin_thres, bucket_cap=bucket_cap, device=device,
                         use_supermers=use_supermers)
        self.H, self.D = H, D

    @staticmethod
    def _set_host(payload, t_host, fns: RecordFns):
        """Write each row's target host into its meta word's spare bits."""
        mc, sh = fns.meta_col, fns.host_shift
        meta = widen(payload[..., mc]) & ~(0xFF << sh)
        payload[..., mc] = narrow(meta | (t_host.to(torch.int64) << sh))

    @staticmethod
    def _get_host(rows, fns: RecordFns):
        return ((widen(rows[..., fns.meta_col]) >> fns.host_shift) & 0xFF).to(torch.int32)

    def _route(self, payload, target, valid, cap: int, fns: RecordFns):
        """Stage A, the combine presum and stage B (reference
        multihost.py:137-163) over the rank's Hl hosts (all H in a world of
        one, else its own); n_sent counts stage A's sends, as the
        reference's."""
        H, D, S, R = self.H, self.D, self.S, fns.R
        W = comm.world()
        Hl, n_loc = H // W, self.n_local
        self._set_host(payload, target // D, fns)
        bucketsA, overA, (lp, lt_dev, lv), _fill = _bucketize(payload, target % D, valid, D, cap)
        # stage A: slot (h, d_src, d_dst) reaches device d_dst of host h
        rows = bucketsA.view(Hl, D, D, cap, R).transpose(1, 2).reshape(n_loc, D * cap, R)
        del bucketsA
        rows, th, va, n_comb = _presum_duplicates(
            rows, self._get_host(rows, fns), fns.is_valid(rows.view(-1, R)).view(n_loc, D * cap),
            fns.count_of, fns.with_count, fns.mode)
        # stage B: at most D * cap rows into buckets of D * cap, no leftovers;
        # slot (h_src, d, w, h_dst) reaches device d of host w * Hl + h_dst,
        # one message per pair of ranks
        bucketsB, _, _, fill = _bucketize(rows, th, va, H, D * cap)
        del rows, th, va
        send = bucketsB.view(Hl, D, W, Hl, D * cap, R).permute(2, 3, 1, 0, 4, 5)
        del bucketsB
        n_over = int(overA.sum())
        n_sent = int(valid.sum()) - n_over
        # (W_src, Hl_dst, D, Hl_src, D * cap, R)
        with comm.stage(COUNT_EXCHANGE, records=n_sent):
            recv = comm.exchange_rows(send, fill.view(Hl, D, W, Hl).permute(2, 3, 1, 0))[0]
        del send
        recv = recv.permute(1, 2, 0, 3, 4, 5).reshape(n_loc, H * D * cap, R)
        # the leftovers' global targets, rebuilt from the host bits
        g = torch.where(lv, self._get_host(lp, fns) * D + lt_dev, S)
        return recv, n_sent, n_over, n_comb, (lp, g, lv)
