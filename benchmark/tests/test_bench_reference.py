"""The plain reference against the program, on the CPU at tiny sizes:
merged pairs, each round's contigs, and the control that has to differ."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.gen.community import make_community
from benchmark.reference.assemble import assemble
from benchmark.reference.merge import merge_pairs
from benchmark.tests import communities

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(name: str, genomes: int = 3, genome_len: int = 20_000, pairs: int = 2_400) -> dict:
    return communities.config(name, genomes=genomes, genome_len=genome_len, pairs=pairs)


def _with_ns_and_repeats(com, rng):
    """Pairs with N bases and low-complexity reads mixed in: the merge's
    abort and ambiguity rules."""
    c1, q1, c2, q2 = (x.copy() for x in (com.codes1, com.quals1, com.codes2, com.quals2))
    P, L = c1.shape
    rows = rng.choice(P, P // 4, replace=False)
    for r in rows[: len(rows) // 2]:
        at = rng.choice(L, rng.integers(1, 5), replace=False)
        (c1 if r % 2 else c2)[r, at] = 4
    for r in rows[len(rows) // 2 :]:
        unit = rng.integers(0, 4, rng.integers(1, 4))
        c1[r] = np.resize(unit, L)
        c2[r] = np.resize(3 - unit[::-1], L)
    return c1, q1, c2, q2


@pytest.mark.parametrize("name", communities.NAMES)
def test_merge_equals_the_program(name):
    from mhm2_proxy_tpu_torch.io.merge import merge_reads_arrays

    cfg = tiny(name, pairs=3_000)
    rng = np.random.default_rng(4)
    c1, q1, c2, q2 = _with_ns_and_repeats(make_community(cfg, 2**31 + 3), rng)
    P, L = c1.shape
    lens = np.full(P, L, np.int32)
    lens[:50] = rng.integers(20, L, 50)  # shorter read 1s
    for i in range(50):
        c1[i, lens[i]:] = 4
    t = torch.from_numpy
    merged, mc, mq, ml = (x.numpy() for x in merge_pairs(t(c1), t(q1), t(lens), t(c2), t(q2),
                                                        t(np.full(P, L, np.int32))))
    off = cfg["qual_offset"]
    for native in (False, True):
        out = merge_reads_arrays(c1, q1 + off, lens, c2, q2 + off, np.full(P, L, np.int32),
                                 qual_offset=off, use_native=native, device="cpu")
        got = out["merged"].astype(bool)
        assert (got == merged).all()
        for i in np.nonzero(merged)[0]:
            n = ml[i]
            assert out["m_len"][i] == n
            assert (out["m_codes"][i, :n] == mc[i, :n]).all()
            assert (out["m_quals"][i, :n].astype(np.int64) - off == mq[i, :n]).all()
    assert 0 < merged.sum() < P


def _program_rounds(cfg, com, tmp):
    from mhm2_proxy_tpu_torch.models.assembler import Assembler, AssemblerConfig

    from benchmark.gen.community import write_fastq

    fq = os.path.join(tmp, "r.fastq")
    write_fastq(com, fq, cfg["qual_offset"])
    asm = Assembler(AssemblerConfig(kmer_lens=tuple(cfg["kmer_lens"]), device="cpu",
                                    output_dir=str(tmp)))
    asm.load_reads([fq])
    rounds = {}
    for k in cfg["kmer_lens"]:
        rounds[k] = sorted((c.seq, c.depth) for c in asm.run_round(k))
    return rounds


def _reference_rounds(cfg, com, depth_dtype=None):
    from benchmark.traffic.ladder import reference_reads

    class Ctx:
        state = {"community": com}

    _, reads = reference_reads(Ctx, torch.device("cpu"))
    return assemble(reads, cfg["kmer_lens"], cfg["min_depth_thres"], depth_dtype=depth_dtype)


@pytest.mark.parametrize("name,seed", [("uniform2x100", 2**31 + 5), ("cami_low12", 6)])
def test_contigs_equal_the_program(name, seed, tmp_path):
    cfg = tiny(name)
    com = make_community(cfg, seed)
    ref = _reference_rounds(cfg, com)
    prog = _program_rounds(cfg, com, tmp_path)
    for k in cfg["kmer_lens"]:
        assert prog[k] == ref[k], k
    assert len(ref[cfg["kmer_lens"][0]]) > 5


def test_control_differs():
    """Depths divided in float32 (the control) change the contigs' records."""
    from benchmark.traffic.ladder import expected_records, records_diff

    cfg = tiny("uniform2x100")
    com = make_community(cfg, 8)
    ref = _reference_rounds(cfg, com)
    ctl = _reference_rounds(cfg, com, depth_dtype="float32")
    diff = sum(records_diff(expected_records(ctl[k]), expected_records(ref[k]))
               for k in cfg["kmer_lens"])
    assert diff > 0


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.merge, benchmark.reference.align, "
            "benchmark.reference.assemble; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    tops = set(eval(out))
    assert not tops & {"mhm2_proxy_tpu_torch", "mhm2_proxy_tpu", "jax", "jaxlib", "flax"}


def test_post_asm_control_differs():
    """Scores of 8-bit alignment cells (the control) in place of AS fail
    the records of reads that score above 127."""
    from benchmark import run
    from benchmark.traffic import post_asm

    cfg = tiny("uniform2x100", genomes=2, genome_len=12_000, pairs=960)
    params = {"warmup_reads": 512, "check_reads": 300, "check_longest": 20}
    wl = communities.workload("uniform2x100", "post_asm", params)
    out = run.run_cell(wl["name"], 12345, 0, False, device="cpu", require_chip=False,
                       config=cfg, workload=wl,
                       check_fn=lambda ctx, jobs: post_asm.check(ctx, jobs, score_bits=8))
    assert not out["correct"] and out["checks"]["sam_records_wrong"]["value"] > 0
