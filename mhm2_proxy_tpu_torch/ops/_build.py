"""Build and load the port's CUDA kernels.

nvcc compiles every source under csrc/*.cu for sm_90a into
`_build/<hash>/libmhm2_kernels.so` at the first kernel launch of a process,
through _native_build.build_library (keyed by a hash of the sources and
flags, built under a temporary name and renamed into place); ctypes loads
it. One nvcc per source runs in parallel, then one links them. The sources
have a plain C interface and include no PyTorch header, so a build takes
seconds. A failed build raises: there is no fallback.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \\
         -c -o <name>.o csrc/<name>.cu           # each source, all at once
    nvcc -shared -o libmhm2_kernels.so *.o
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

from .._native_build import build_library, run

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-lineinfo",
    "-Xptxas", "-v", "-Xcompiler", "-fPIC",
]

_lib = None
build_seconds: float | None = None  # wall time of this process's build (None: cached)
library_path: Path | None = None

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_int64
U32 = ctypes.c_uint32
U64 = ctypes.c_uint64

# C entry points -> argtypes (each returns a cudaError_t as int, but for
# those in _RESTYPES)
_SIGNATURES = {
    "mhm2_extract": [P, P, P, I64, I32, I32, I32, P, I32, P],
    "mhm2_merge": [P, P, I64, P, P, I64, P, P, I32, I32, P, I64, P],
    "mhm2_merge_tile_rows": [I32],
    "mhm2_range_cuts": [P, P, P, I32, I32, P, P, P],
    "mhm2_finalize": [P, I32, I32, I64, U32, I32, I32, I32, P, P, P, P, I64, P, P, I64, P],
    "mhm2_compact": [P, P, I32, P, I32, I64, I32, I32, P, P, P, P, P, P, P, I32, P, P, I64, P,
                     I64, P],
    "mhm2_join": [P, I32, P, I64, P, I32, I32, P, I64, P, I64, P],
    "mhm2_join_sep": [P, I32, P, P, I64, P, I32, P, I64, P, I64, P],
    "mhm2_join_scratch_bytes": [I64, I32],
    "mhm2_scan_lanes": [P, I32, P, I64, I32, P, P, I64, P, P, I64, P],
    "mhm2_scan_packed": [P, I32, I64, U32, I32, P, P, I64, P, P, I64, P],
    "mhm2_ssw": [P, P, P, P, I64, I32, I32, I32, I32, I32, I32, I32, P, P, P],
    "mhm2_minimizer": [P, I64, I32, I32, I32, U32, U64, U32, P, P],
}


_RESTYPES = {"mhm2_join_scratch_bytes": ctypes.c_int64}


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


def _compile_kernels(tmp: Path) -> tuple[str, str | None]:
    """Each csrc/*.cu to an object by its own nvcc, all at once, then one
    link into tmp."""
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_name(f"{src.stem}.{tmp.stem}.o")
        cmd = [nvcc, *FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, err = [], None
    for cmd, _obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0 and err is None:
            err = out
    if err is None:
        line, err = run([nvcc, "-shared", "-o", str(tmp), *[str(o) for _c, o, _p in jobs]])
        log.append(line)
    for _c, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    return "\n".join(log), err


def load():
    """The loaded kernel library, building it first if needed."""
    global _lib, build_seconds, library_path
    if _lib is not None:
        return _lib
    so, build_seconds = build_library("libmhm2_kernels.so", _sources(), FLAGS, _compile_kernels)
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    library_path = so
    _lib = lib
    return lib
