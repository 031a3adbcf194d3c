"""The cross-rank collectives of every cross-shard step.

A run has W processes (ranks); rank r holds the shards [r * D, (r + 1) * D)
of the S = W * D shards, host-major, so every per-shard tensor on a rank has
a leading axis of D. Without a process group the run is a world of one: the
rank holds every shard and each collective is its local identity (the
all-to-all a transpose). With a group, even one of a single rank, each
collective goes through torch.distributed.

The spans of utils/trace.py are the one record of what crosses ranks.
Each collective counts, on the innermost open span, `sent_bytes` (the
bytes the rank sends to other ranks; its own chunk of an all-to-all stays
home) and `collectives` (one a call), and an all-to-all its bytes as
`alltoall_bytes` besides; its callers open `stage()` spans around them
(`count.exchange`, `traverse.exchange`), so a job's sums over its spans
hold every byte and call. While a trace records, a collective drains the
device's queued work before and after it, so that its span holds the
transport's own time; that serializes the stream around every collective,
so untraced nothing is drained.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from ..utils import trace

# the spans of the exchange's collectives (stage()) while counting and while
# traversing
COUNT_EXCHANGE = "count.exchange"
TRAVERSE_EXCHANGE = "traverse.exchange"


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def _scalar_device() -> torch.device:
    """Where small tensors of host values go: NCCL takes only CUDA tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _drain() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage(name: str, **counters):
    """A span `name` over one step of the cross-rank exchange, with
    `counters` on it; the collectives inside count their bytes and calls on
    it. While a trace records in a multi-process run, the device's queued
    work is drained before the span opens, so that it holds the step's own
    time; otherwise it adds no sync."""
    if active() and trace.is_recording():
        _drain()
    with trace.span(name) as sp:
        for c, n in counters.items():
            trace.count(c, n)
        yield sp


class _counted:
    """Counts one collective as `sent_bytes` and `collectives` on the
    innermost span, an all-to-all's bytes also as `alltoall_bytes`; while a
    trace records, drains the device's queued work before and after it."""

    def __init__(self, tensor: torch.Tensor | None = None, sent: int = 0,
                 alltoall: bool = False):
        self.cuda = trace.is_recording() and tensor is not None and tensor.is_cuda
        self.sent = sent
        self.alltoall = alltoall

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        trace.count("sent_bytes", self.sent)
        if self.alltoall:
            trace.count("alltoall_bytes", self.sent)
        trace.count("collectives")
        return False


def exchange(send: torch.Tensor) -> torch.Tensor:
    """(W, ...) -> (W, ...): chunk w of every rank's send goes to rank w, and
    chunk w of what comes back is rank w's. One all_to_all_single; a world
    of one returns send."""
    if not active():
        return send
    W = world()
    if send.shape[0] != W:
        raise ValueError(f"exchange: leading axis {send.shape[0]} for {W} ranks")
    send = send.contiguous()
    recv = torch.empty_like(send)
    with _counted(send, send.numel() * send.element_size() * (W - 1) // W, alltoall=True):
        dist.all_to_all_single(recv, send)
    return recv


def exchange_rows(send: torch.Tensor, fill: torch.Tensor):
    """exchange() of buckets that hold rows in a prefix of their slots:
    send (W, ..., cap, *row), fill (W, ...) the rows each bucket holds.
    Only those rows travel (one all_to_all_single with split sizes, after
    one of the fills); the buckets come back zero-padded to cap. Returns
    (recv, recv_fill)."""
    if not active():
        return send, fill
    lead = fill.dim()
    cap = send.shape[lead]
    slots = torch.arange(cap, device=send.device)
    rows = send[slots < fill[..., None]]  # by rank, bucket and slot
    fill_in = exchange(fill.to(torch.int64))
    n_out = fill.reshape(world(), -1).sum(1).tolist()
    n_in = fill_in.reshape(world(), -1).sum(1).tolist()
    got = torch.empty((sum(n_in), *send.shape[lead + 1:]), dtype=send.dtype, device=send.device)
    sent = (sum(n_out) - n_out[rank()]) * rows[:1].numel() * rows.element_size()
    with _counted(send, sent, alltoall=True):
        dist.all_to_all_single(got, rows.contiguous(), output_split_sizes=n_in,
                               input_split_sizes=n_out)
    recv = torch.zeros(send.shape, dtype=send.dtype, device=send.device)
    recv[slots < fill_in[..., None]] = got
    return recv, fill_in


def _to_ranks(buckets):
    D, S = buckets.shape[:2]
    W = S // D
    if W * D != S or W != world():
        raise ValueError(f"all_to_all: {D} local shards of {S} over {world()} ranks")
    return buckets.view(D, W, D, *buckets.shape[2:]).transpose(0, 1)


def _from_ranks(recv):
    W, D = recv.shape[:2]
    out = recv.permute(2, 0, 1, *range(3, recv.dim())).reshape(D, W * D, *recv.shape[3:])
    return out.contiguous()


def all_to_all(buckets: torch.Tensor, fill: torch.Tensor):
    """(D_src, S_dst, cap, R) buckets, their rows in a prefix of fill (D_src,
    S_dst) slots -> (D_dst, S_src, cap, R) and its fill (D_dst, S_src): slot
    (src, dst) of every source shard reaches destination shard dst. A
    local regroup by destination rank (W_dst, D_src, D_dst, ...), one
    exchange of the filled rows, and a regroup by source shard; in a world
    of one, a transpose."""
    recv, fill_in = exchange_rows(_to_ranks(buckets), _to_ranks(fill))
    return _from_ranks(recv), _from_ranks(fill_in)


def _reduce(values, op: str):
    """Global reductions (dist.ReduceOp op) of host integers: one value
    gives an int, several a list."""
    out = list(values)
    if active():
        t = torch.tensor(out, dtype=torch.int64, device=_scalar_device())
        with _counted(t):
            dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        out = t.tolist()
    return out[0] if len(values) == 1 else out


def all_sum(*values: int):
    return _reduce(values, "SUM")


def all_max(*values: int):
    return _reduce(values, "MAX")


def any_true(flag: bool) -> bool:
    return bool(all_max(int(bool(flag))))


def all_sum_tensor(t: torch.Tensor) -> torch.Tensor:
    """The global elementwise sum of a small tensor (on t's device)."""
    if not active():
        return t
    x = t.to(_scalar_device(), copy=True)
    with _counted(x):
        dist.all_reduce(x)
    return x.to(t.device)


def all_gather_array(values, dtype=np.int64) -> np.ndarray:
    """(W, n): every rank's n host values, by rank."""
    a = np.asarray(values, dtype=dtype).reshape(-1)
    if not active():
        return a[None]
    t = torch.from_numpy(a).to(_scalar_device())
    out = torch.empty((world() * a.size,), dtype=t.dtype, device=t.device)
    with _counted(t):
        dist.all_gather_into_tensor(out, t)
    return out.cpu().numpy().reshape(world(), a.size)


def exclusive_scan(counts: torch.Tensor):
    """counts (D,): this rank's per-shard counts. Returns (offsets (D,)
    int64 on counts' device: each local shard's exclusive prefix over the
    global host-major shard order, every shard's count (S,) int64 numpy)."""
    every = all_gather_array(counts.cpu().numpy()).reshape(-1)
    before = np.concatenate([[0], np.cumsum(every)[:-1]])
    D = counts.shape[0]
    mine = before[rank() * D:(rank() + 1) * D]
    return torch.from_numpy(mine.copy()).to(counts.device), every


def all_gather_bytes(payload: bytes) -> list[bytes]:
    """Every rank's payload, by rank (a world of one: [payload])."""
    if not active():
        return [payload]
    sizes = all_gather_array([len(payload)]).reshape(-1)
    n = max(int(sizes.max()), 1)
    dev = _scalar_device()
    buf = torch.zeros((n,), dtype=torch.uint8)
    if payload:
        buf[: len(payload)] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    buf = buf.to(dev)
    out = torch.empty((world() * n,), dtype=torch.uint8, device=dev)
    with _counted(buf, n * (world() - 1)):
        dist.all_gather_into_tensor(out, buf)
    host = out.cpu().numpy().reshape(world(), n)
    return [host[w, : int(sizes[w])].tobytes() for w in range(world())]


def barrier() -> None:
    if active():
        with _counted():
            dist.barrier()
