"""Registry of the port's hand-written CUDA kernels.

Each kernel's wrapper (ops/extract.py, sort.py, finalize.py, compact.py,
join.py, scan.py, ssw.py, minimizer.py) launches the kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; nothing else chooses between them. There
is no switch that
turns a kernel off and no fallback after a failed build or launch: both
raise. Each wrapper adds one to its kernel's launch count where it launches
the kernel, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

# kernel -> (CUDA source, what it replaces in the reference: a TPU kernel,
# or, for range_cuts, the host's numpy quantile of the ranged fold)
KERNELS = {
    "extract": ("mhm2_proxy_tpu_torch/csrc/extract.cu",
                "mhm2_proxy_tpu/ops/pallas_extract.py:179"),
    "sort": ("mhm2_proxy_tpu_torch/csrc/sort.cu",
             "mhm2_proxy_tpu/ops/pallas_sort.py:158"),
    "finalize": ("mhm2_proxy_tpu_torch/csrc/finalize.cu",
                 "mhm2_proxy_tpu/ops/pallas_finalize.py:246"),
    "compact": ("mhm2_proxy_tpu_torch/csrc/compact.cu",
                "mhm2_proxy_tpu/ops/pallas_compact.py:115"),
    "join": ("mhm2_proxy_tpu_torch/csrc/join.cu",
             "mhm2_proxy_tpu/ops/pallas_join.py:157"),
    "scan": ("mhm2_proxy_tpu_torch/csrc/scan.cu",
             "mhm2_proxy_tpu/ops/pallas_scan.py:245"),
    "ssw": ("mhm2_proxy_tpu_torch/csrc/ssw.cu",
            "mhm2_proxy_tpu/ops/pallas_ssw.py:108"),
    "minimizer": ("mhm2_proxy_tpu_torch/csrc/minimizer.cu",
                  "mhm2_proxy_tpu/ops/pallas_minimizer.py:179"),
    "range_cuts": ("mhm2_proxy_tpu_torch/csrc/sort.cu",
                   "mhm2_proxy_tpu/kcount/kmer_store.py:476"),
}

_launches = dict.fromkeys(KERNELS, 0)


def count_launch(name: str) -> None:
    _launches[name] += 1


def launches() -> dict[str, int]:
    return dict(_launches)


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0


# (kernel, device) -> [status words, ticket, the last call's generation]
_look_back: dict = {}
_GEN_LIMIT = (1 << 31) - 1


def look_back_scratch(name: str, dev, words: int):
    """A decoupled look-back's scratch for a call of kernel `name` on `dev`:
    int64 status words (zeroed once, then made stale by each call's
    generation), the int32 tile ticket (0 between calls) and this call's
    generation, in [1, 2^31)."""
    s = _look_back.get((name, dev))
    if s is None or s[0].numel() < words or s[2] + 1 >= _GEN_LIMIT:
        cap = max(words, 2 * s[0].numel() if s is not None else 1 << 16)
        s = [torch.zeros((cap,), dtype=torch.int64, device=dev),
             torch.zeros((1,), dtype=torch.int32, device=dev), 0]
        _look_back[(name, dev)] = s
    s[2] += 1
    return s


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors (plain
    version); raises for mixed or other devices."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all be on one CUDA device or all on the CPU: {types}")


def require(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_lane(t: torch.Tensor, name: str) -> None:
    """An int32 lane of any element stride (the sort and compact kernels
    read and write a lane as a pointer plus a stride)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected {torch.int32}, got {t.dtype}")
    if t.dim() != 1:
        raise ValueError(f"{name}: expected a 1-D lane, got shape {tuple(t.shape)}")


def lib():
    from . import _build

    return _build.load()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptrs(tensors) -> ctypes.Array:
    """Host array of device pointers for a C `void* const*` argument."""
    tensors = list(tensors)
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def strides(tensors) -> ctypes.Array:
    """Host array of the 1-D lanes' element strides (`const int64_t*`)."""
    tensors = list(tensors)
    return (ctypes.c_int64 * len(tensors))(*[t.stride(0) for t in tensors])


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
