"""The port imports no jax, and CPU tensors never launch a CUDA kernel."""

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import mhm2_proxy_tpu_torch, mhm2_proxy_tpu_torch.main\n"
        "from mhm2_proxy_tpu_torch import kcount, dbjg, models, io, utils, options\n"
        "from mhm2_proxy_tpu_torch.ops import (bitkmer, compact, count, extract, finalize,\n"
        "    join, kernels, lookup, sort, u32, _build)\n"
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


def test_cpu_tensors_leave_launch_counts_at_zero():
    from mhm2_proxy_tpu_torch.ops import compact, count, extract, finalize, kernels, lookup, sort

    kernels.reset_launches()
    rng = np.random.default_rng(3)
    codes = torch.from_numpy(rng.integers(0, 5, (8, 64), dtype=np.uint8))
    qual = torch.from_numpy(rng.random((8, 64)) > 0.1)
    lens = torch.from_numpy(rng.integers(20, 65, 8).astype(np.int32))
    run = count.block_to_raw_run(codes, qual, lens, 21)
    merged = sort.merge_sorted_lanes(run, run, 2)
    data, flags = finalize.scan_purge(merged, 21, purge=True)
    compact.compact_classes(data, flags, 2, (0,))
    extract.extract_record_lanes(codes, qual, lens, 21)
    words = torch.stack(merged, 1)
    lookup.table_join_payload(words, 10, words, torch.zeros(words.shape[0], dtype=torch.int64),
                              payload_bits=6)
    assert kernels.launches() == {"extract": 0, "sort": 0, "finalize": 0, "compact": 0, "join": 0}


def test_unported_paths_raise():
    import pytest

    from mhm2_proxy_tpu_torch.kcount import KmerCountStore
    from mhm2_proxy_tpu_torch.main import run_pipeline
    from mhm2_proxy_tpu_torch.options import Options

    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 3"):
        KmerCountStore(63, device="cpu")
    for opt in (dict(restart=True), dict(shards=2), dict(profile=True),
                dict(post_asm_align=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
            run_pipeline(Options(reads=["x.fastq"], device="cpu", **opt))
    store = KmerCountStore(21, device="cpu", raw_budget_bytes=16)
    codes = np.full((4, 64), 1, np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9"):
        store.add_reads_block(codes, np.ones((4, 64), bool), np.full(4, 64, np.int32))
