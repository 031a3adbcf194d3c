"""mhm2_proxy_tpu_torch — the PyTorch + CUDA port of mhm2_proxy_tpu.

Same pipeline as the JAX package beside it (FASTQ ingest -> pair merge ->
raw-LSM k-mer counting -> de Bruijn traversal -> contigs) with the same
outputs, on one NVIDIA GPU. Plain tensor code is PyTorch; every Pallas kernel
on the single-device contigging path is a hand-written CUDA C++ kernel for
Hopper (sm_90a) under csrc/, built at first use (ops/_build.py).

u32 data (k-mer words, packed payloads) is held in torch.int32 tensors with
the reference's exact bit patterns, so kernels read uint32_t* over the same
bytes; plain code widens to int64 for unsigned shifts, compares and sorts
(ops/u32.py).

Importing this package never imports jax.
"""

__version__ = "0.1.0"

from . import constants  # noqa: E402,F401
