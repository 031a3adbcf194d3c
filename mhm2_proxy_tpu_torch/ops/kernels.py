"""Registry of the port's hand-written CUDA kernels.

Each kernel's wrapper (ops/extract.py, sort.py, finalize.py, compact.py,
join.py)
launches the kernel for CUDA tensors and runs its plain PyTorch version for
CPU tensors; nothing else chooses between them. There is no switch that
turns a kernel off and no fallback after a failed build or launch: both
raise. Each wrapper adds one to its kernel's launch count where it launches
the kernel, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

# kernel -> (CUDA source, the TPU kernel it replaces)
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
}

_launches = dict.fromkeys(KERNELS, 0)


def count_launch(name: str) -> None:
    _launches[name] += 1


def launches() -> dict[str, int]:
    return dict(_launches)


def reset_launches() -> None:
    for name in _launches:
        _launches[name] = 0


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


def lib():
    from . import _build

    return _build.load()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptrs(tensors) -> ctypes.Array:
    """Host array of device pointers for a C `void* const*` argument."""
    tensors = list(tensors)
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
