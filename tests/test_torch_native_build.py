"""The port's host library (io/native.py: the one-pass parser, the pair
merge and the stitcher) is built by _native_build.build_library, as the
CUDA kernels are: under mhm2_proxy_tpu_torch/_build/<hash>/, keyed by its
sources and flags, never inside native/ (the JAX package's directory,
whose sources it reads in place).

The loads run in a copy of the package and of native/'s sources under
tmp_path, so that the build directory starts empty and native/ holds no
library, and nothing else that runs at the same time touches either."""

import logging
import os
import shutil
import subprocess
import sys

import pytest

from mhm2_proxy_tpu_torch import _native_build
from mhm2_proxy_tpu_torch.io import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_cxx = pytest.mark.skipif(shutil.which("c++") is None and shutil.which("g++") is None,
                               reason="no C++ compiler for the host library")

# one process's load: the library's path, then a digest of merge_pairs on a
# seeded block of pairs
LOAD = """
import hashlib, sys
import numpy as np
from mhm2_proxy_tpu_torch.io import native
assert native.merge_available() and native.parse_into_available()
assert native.get_stitch_walk() is not None
rng = np.random.default_rng(5)
B, L = 64, 100
c1, c2 = rng.integers(0, 4, (2, B, L), dtype=np.uint8)
c2[: B // 2, 30:] = 3 - c1[: B // 2, ::-1][:, 30:]  # half the pairs overlap
q1, q2 = rng.integers(35, 75, (2, B, L), dtype=np.uint8)
lens = np.full(B, L, np.int32)
got = native.merge_pairs(c1, q1, lens, c2, q2, lens, n_threads=2)
h = hashlib.sha256()
for key in sorted(got):
    h.update(np.asarray(got[key]).tobytes())
print(native._lib._name)
print(h.hexdigest())
"""


def _tree(tmp_path):
    """A copy of the package (no _build/) and of native/'s sources (no
    library) under tmp_path."""
    shutil.copytree(os.path.join(ROOT, "mhm2_proxy_tpu_torch"),
                    tmp_path / "mhm2_proxy_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(os.path.join(ROOT, "native"), tmp_path / "native",
                    ignore=shutil.ignore_patterns("*.so", "__pycache__"))
    return tmp_path


def _listing(d):
    return sorted((p.name, p.stat().st_mtime_ns, p.stat().st_size) for p in d.iterdir())


def _load(tree):
    env = dict(os.environ, PYTHONPATH=str(tree), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", LOAD], cwd=tree, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _expected_library(tree):
    srcs = [tree / "mhm2_proxy_tpu_torch" / "csrc" / "fastq_into.cpp",
            tree / "native" / "merge_native.cpp", tree / "native" / "stitch_native.cpp"]
    h = _native_build.source_hash(srcs, native._CXXFLAGS + native._LIBS)
    return tree / "mhm2_proxy_tpu_torch" / "_build" / h / "libmhm2_host.so"


@needs_cxx
def test_host_library_builds_under_build_and_leaves_native_unchanged(tmp_path):
    """A load from an empty build directory, with no library in native/
    (where the loader once ran make): native/'s listing and mtimes are the
    same after it, and the library sits under the package's
    _build/<hash>/ with its build.log and no temporary file."""
    tree = _tree(tmp_path)
    before = _listing(tree / "native")
    proc = _load(tree)
    out = proc.communicate(timeout=120)[0]
    assert proc.returncode == 0, out[-3000:]
    assert _listing(tree / "native") == before
    so = _expected_library(tree)
    assert out.splitlines()[0] == str(so)
    assert sorted(p.name for p in so.parent.iterdir()) == ["build.log", "libmhm2_host.so"]
    assert "-lpthread" in (so.parent / "build.log").read_text()


@needs_cxx
def test_four_processes_load_one_library(tmp_path):
    """Four processes that load the library at once into an empty build
    directory each build it under their own temporary name and all load
    the one library renamed into place; their merges agree with this
    process's."""
    tree = _tree(tmp_path)
    procs = [_load(tree) for _ in range(4)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    so = _expected_library(tree)
    assert {tuple(out.splitlines()[:2]) for out in outs} == {(str(so), outs[0].splitlines()[1])}
    assert sorted(p.name for p in so.parent.iterdir()) == ["build.log", "libmhm2_host.so"]
    here = subprocess.run([sys.executable, "-c", LOAD], cwd=ROOT, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert here.returncode == 0, here.stdout + here.stderr
    assert here.stdout.splitlines()[1] == outs[0].splitlines()[1]


def test_build_library_builds_once_and_failures_leave_nothing(tmp_path, monkeypatch):
    """build_library keys a library by its sources' names and bytes and its
    flags: a second call finds it built and compiles nothing; new bytes or
    new flags build another. A failed build raises with the compiler's
    words, keeps them in build.log, and leaves no library and no
    temporary file."""
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "_build")
    src = tmp_path / "a.c"
    src.write_text("int a;\n")
    calls = []

    def compile(tmp):
        calls.append(tmp)
        tmp.write_bytes(b"lib")
        return "built\n", None

    so, secs = _native_build.build_library("liba.so", [src], ["-O1"], compile)
    assert so.read_bytes() == b"lib" and secs is not None and len(calls) == 1
    assert so.parent.name == _native_build.source_hash([src], ["-O1"])
    assert (so.parent / "build.log").read_text() == "built\n"
    assert _native_build.build_library("liba.so", [src], ["-O1"], compile) == (so, None)
    assert len(calls) == 1
    other = {_native_build.build_library("liba.so", [src], ["-O2"], compile)[0]}
    src.write_text("int b;\n")
    other.add(_native_build.build_library("liba.so", [src], ["-O1"], compile)[0])
    assert len(calls) == 3 and len(other | {so}) == 3

    def broken(tmp):
        tmp.write_bytes(b"half")
        return "cc a.c\nerror: no\n", "error: no\n"

    with pytest.raises(RuntimeError, match="error: no"):
        _native_build.build_library("libb.so", [src], ["-O1"], broken)
    d = _native_build.BUILD_DIR / _native_build.source_hash([src], ["-O1"])
    assert sorted(p.name for p in d.iterdir()) == ["build.log", "liba.so"]
    assert "error: no" in (d / "build.log").read_text()


def test_a_failed_host_build_is_logged_once(tmp_path, monkeypatch, caplog):
    """Where the host library does not build, the parser, the merge and the
    stitcher are all unavailable, and the log says why once: the
    compiler's last words and the path of build.log."""
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_compile", lambda tmp: ("c++ ...\nerror: no\n", "error: no\n"))
    with caplog.at_level(logging.WARNING, logger="mhm2_proxy_tpu_torch"):
        assert not native.merge_available() and not native.parse_into_available()
        assert native.get_stitch_walk() is None
    said = [r.getMessage() for r in caplog.records if "host library" in r.getMessage()]
    assert len(said) == 1, said
    assert "error: no" in said[0]
    assert str(tmp_path / "_build") in said[0] and "build.log" in said[0]


def test_host_library_links_three_sources_with_the_makefiles_flags():
    """The host library links three sources, read in place (the parser from
    csrc/, the merge and the stitcher from native/), under native/Makefile's
    flags, so that the merge is the code that Makefile's library holds."""
    assert [p.relative_to(ROOT).as_posix() for p in native.SOURCES] == [
        "mhm2_proxy_tpu_torch/csrc/fastq_into.cpp", "native/merge_native.cpp",
        "native/stitch_native.cpp"]
    make = open(os.path.join(ROOT, "native", "Makefile")).read()
    for flag in ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared", "-lpthread"):
        assert flag in make and flag in native._CXXFLAGS + native._LIBS
    assert all(f.exists() for f in native.SOURCES)


def test_build_module_imports_neither_torch_nor_ops():
    """The build function is host code: importing it pulls in neither torch
    nor the device ops package, whose kernels it also builds."""
    code = ("import sys\nimport mhm2_proxy_tpu_torch._native_build\n"
            "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith("
            "('torch.', 'mhm2_proxy_tpu_torch.ops'))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=ROOT), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip() == "[]"
