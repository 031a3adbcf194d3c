"""The port imports no jax, and CPU tensors never launch a CUDA kernel."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import mhm2_proxy_tpu_torch, mhm2_proxy_tpu_torch.main\n"
        "from mhm2_proxy_tpu_torch import kcount, dbjg, models, io, utils, options\n"
        "from mhm2_proxy_tpu_torch.models import assembler, post_asm\n"
        "from mhm2_proxy_tpu_torch.ops import (bitkmer, compact, count, extract, finalize,\n"
        "    join, kernels, lookup, minimizer, scan, sort, ssw, u32, u64, _build)\n"
        "from mhm2_proxy_tpu_torch.parallel import comm, multihost, sharded\n"
        "from mhm2_proxy_tpu_torch import launcher, parse_run_log\n"
        "from mhm2_proxy_tpu_torch.dbjg import traverse_sharded, stitch_sharded\n"
        "from mhm2_proxy_tpu_torch.io import merge, native, gfa, stream\n"
        "from mhm2_proxy_tpu_torch.utils import memlog\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mhm2_proxy_tpu.')) or m == 'mhm2_proxy_tpu')\n"
        "print('LEAKED', bad)\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LEAKED []" in res.stdout


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py (which imports lazily, inside its phases) names neither
    jax nor the JAX package in any import statement."""
    import ast

    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    bad = sorted(n for n in names if n.split(".")[0] in ("jax", "mhm2_proxy_tpu"))
    assert not bad and "mhm2_proxy_tpu_torch.models.post_asm" in names, bad


def test_cpu_tensors_leave_launch_counts_at_zero():
    from mhm2_proxy_tpu_torch.ops import (compact, count, extract, finalize, kernels, lookup,
                                          minimizer, scan, sort, ssw)

    kernels.reset_launches()
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 5, (8, 64), dtype=np.uint8))
    qual = torch.from_numpy(rng.random((8, 64)) > 0.1)
    lens = torch.from_numpy(rng.integers(20, 65, 8).astype(np.int32))
    run = count.block_to_raw_run(codes, qual, lens, 21)
    merged = sort.merge_sorted_lanes(run, run, 2)
    finalize.scan_purge_compact(merged, 21, 2, purge=True)
    compact.compact_classes(merged, merged[0] & 1, 2, (0,))
    extract.extract_record_lanes(codes, qual, lens, 21)
    scan.group_sums_scan_packed(merged, finalize._keymask(21, 2), 0xFFFF)
    scan.group_sums_scan_lanes(merged, torch.ones(merged[0].shape[0], dtype=torch.bool), 0xFFFF)
    words = torch.stack(merged, 1)
    for bits in (6, 32):  # the fused and the separate-lane join
        lookup.table_join_payload(words, 10, words, torch.zeros(words.shape[0], dtype=torch.int64),
                                  payload_bits=bits)
    lens = torch.full((8,), 40, dtype=torch.int32)
    ssw.sw_align(codes, lens, codes, lens)
    minimizer.minimizer_targets(codes, 21, 15, 4)
    sort.range_cuts((merged[0], run[0]), (merged[0].shape[0], torch.tensor(3)), 16)
    assert kernels.launches() == {"extract": 0, "sort": 0, "finalize": 0, "compact": 0, "join": 0,
                                  "scan": 0, "ssw": 0, "minimizer": 0, "range_cuts": 0}


def test_unported_paths_raise():
    from mhm2_proxy_tpu_torch.kcount import KmerCountStore

    # ported since: k = 63's separate payload and the collapse past the
    # budget, the flat sharded counter (--shards without --hosts), and the
    # (hosts, devices) layout, which refuses what the reference cannot lay
    # out: shards that do not divide over the hosts, more than 256 hosts
    from mhm2_proxy_tpu_torch.models import Assembler, AssemblerConfig
    from mhm2_proxy_tpu_torch.parallel import HierarchicalCounter

    with pytest.raises(ValueError, match="do not divide"):
        Assembler(AssemblerConfig(device="cpu", n_shards=3, n_hosts=2))._make_store(21)
    with pytest.raises(ValueError, match="8 meta bits"):
        HierarchicalCounter(21, (257, 1), device="cpu")
    assert Assembler(AssemblerConfig(device="cpu", n_shards=4, n_hosts=2))._make_store(21).D == 2
    store = KmerCountStore(63, device="cpu", raw_budget_bytes=16)
    codes = np.full((4, 96), 1, np.uint8)
    store.add_reads_block(codes, np.ones((4, 96), bool), np.full(4, 96, np.int32))
    assert store.stats["collapses"] == 1 and int(store.finalize().n) == 1
    from mhm2_proxy_tpu_torch.parallel import ShardedCounter

    counter = ShardedCounter(21, 2, device="cpu")
    counter.add_reads_block(codes, np.ones((4, 96), bool), np.full(4, 96, np.int32))
    assert int(counter.finalize().n.sum()) == 1


# the port's copies of framework-free host modules of the JAX package: the
# verbatim ones (0 differing lines) and the adapted ones with the number of
# lines that differ (the --device option and prog name, the citation of the
# reference's source, the logger's file name; the launcher's child module,
# its two torch out-of-memory markers and torch.distributed; the parser's
# log name and its note on the multi-process [module] line; the packed
# reads' counting blocks, built once a job in pinned memory). io/stream.py
# and io/native.py are no copies since the port parses FASTQ in one pass
# into the block being filled: tests/test_torch_stream.py holds the
# port's blocks against the JAX package's instead.
COPIED_MODULES = {
    "io/fastq.py": 0, "io/reads.py": 97, "io/fasta.py": 0, "utils/synth.py": 0,
    "constants.py": 2, "options.py": 25, "io/gfa.py": 7, "utils/logger.py": 8,
    "launcher.py": 8, "parse_run_log.py": 7,
}


@pytest.mark.parametrize("path", sorted(COPIED_MODULES))
def test_copied_host_modules_do_not_drift(path):
    """Read as text (nothing of the JAX package is imported): a copy equals
    the reference byte for byte, or differs in exactly its known lines."""
    import difflib

    ref = open(os.path.join(ROOT, "mhm2_proxy_tpu", path), "rb").read()
    port = open(os.path.join(ROOT, "mhm2_proxy_tpu_torch", path), "rb").read()
    diff = [line for line in difflib.unified_diff(ref.decode().splitlines(),
                                                  port.decode().splitlines(), lineterm="", n=0)
            if line[:1] in "+-" and not line.startswith(("+++", "---"))]
    assert len(diff) == COPIED_MODULES[path], diff
    if COPIED_MODULES[path] == 0:
        assert port == ref
