"""Build and load the port's CUDA kernels (csrc/*.cu -> one shared library).

nvcc compiles every source under csrc/ for sm_90a into
`mhm2_proxy_tpu_torch/_build/<hash>/libmhm2_kernels.so`, keyed by a hash of
the sources and flags, at the first kernel launch of a process; ctypes
loads it. The sources have a plain C interface and include no PyTorch
header, so a build takes seconds. A failed build raises: there is no
fallback.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o libmhm2_kernels.so csrc/*.cu
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-lineinfo",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

_lib = None
build_seconds: float | None = None  # wall time of this process's build (None: cached)
library_path: Path | None = None

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
U32 = ctypes.c_uint32

# C entry points -> argtypes (each returns a cudaError_t as int)
_SIGNATURES = {
    "mhm2_extract": [P, P, P, I64, I32, I32, I32, P, I32, P],
    "mhm2_merge": [P, I64, P, I64, P, I32, I32, I64, P, P],
    "mhm2_finalize": [P, I32, I64, U32, I32, I32, P, P, P, P, P, P],
    "mhm2_compact_count": [P, I64, I32, P, P],
    "mhm2_compact_scatter": [P, P, I32, P, I64, I32, I32, P, P],
    "mhm2_join": [P, I32, P, I64, P, I32, I32, P, I64, P],
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA_HOME/bin, PATH): the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in _sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def load():
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds, library_path
    if _lib is not None:
        return _lib
    out_dir = BUILD_DIR / source_hash()
    so = out_dir / "libmhm2_kernels.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libmhm2_kernels.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), *[str(f) for f in CSRC.glob("*.cu")]]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}) building {so}:\n{res.stderr[-4000:]}"
            )
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    library_path = so
    _lib = lib
    return lib
