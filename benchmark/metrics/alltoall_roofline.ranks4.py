"""The all-to-alls' share of NVLink's rate: the bytes rank 0 sends through
all-to-alls in one assembly (the window jobs' mean of the program's
`alltoall_bytes` counters; every job of a run sends the same) at
NVLINK_BYTES_PER_S, over the device seconds of NCCL's SendRecv kernels in
the profiled job (NCCL runs an all-to-all as grouped sends and receives),
in %. The all-reduces and all-gathers of small values, whose kernels mostly
wait for the other ranks, are left out on both sides.

NVLINK_BYTES_PER_S is NVLink 4's rate in one direction for one H100 SXM
(18 links of 25 GB/s each way: 450 GB/s). A SendRecv kernel's time also
holds its wait for the other ranks to arrive, so the share is a floor of
the links' use; on a host whose cards talk over PCIe the share only reads
low."""

from benchmark.lib.exchange import sent_bytes
from benchmark.lib.program_trace import hook

NVLINK_BYTES_PER_S = 450e9


def hooks():
    return hook()


def _alltoall_kernel(name: str) -> bool:
    name = name.lower()
    return "nccl" in name and ("sendrecv" in name or "alltoall" in name)


def read(rec):
    b, tr = sent_bytes(rec, "alltoall_bytes"), rec.get("trace")
    if not b or not tr:
        return None
    nccl_s = sum(s for name, s in tr["device_ops"].items() if _alltoall_kernel(name))
    if nccl_s <= 0:
        return None
    return 100.0 * (b / NVLINK_BYTES_PER_S) / nccl_s
