"""Whole runs of the harness on the CPU (no look for a card, a tiny
community) with the timed path broken underneath: each planted fault has to
come out not correct, and the unbroken run correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.tests import communities


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(name: str) -> dict:
    return communities.config(name, genomes=2, genome_len=12_000,
                              pairs=960 if name == "uniform2x100" else 720)


def _unchanged_last_round(mp):
    """The last round returns the state it was given."""
    from mhm2_proxy_tpu_torch.io.fasta import write_fasta
    from mhm2_proxy_tpu_torch.models import assembler

    orig = assembler.Assembler.run_round

    def run_round(self, k):
        if k != self.cfg.kmer_lens[-1]:
            return orig(self, k)
        write_fasta(f"{self.cfg.output_dir}/contigs-{k}.fasta",
                    [(c.id, c.seq, c.depth) for c in self.contigs])
        return self.contigs

    mp.setattr(assembler.Assembler, "run_round", run_round)


def _half_the_reads(mp):
    """Counting takes every other read of each block and drops the rest."""
    from mhm2_proxy_tpu_torch.kcount import kmer_store

    orig = kmer_store.KmerCountStore.add_reads_block

    def add_reads_block(self, codes, qual_ok, lens):
        lens = np.array(lens)
        lens[1::2] = 0
        return orig(self, codes, qual_ok, lens)

    mp.setattr(kmer_store.KmerCountStore, "add_reads_block", add_reads_block)


def _contig_base_flipped(mp):
    """One base of the first contig changes where the traversal renders it."""
    from mhm2_proxy_tpu_torch.models import assembler

    orig = assembler.traverse_debruijn_graph

    def traverse(*a, **kw):
        out = orig(*a, **kw)
        if out:
            seq, depth = out[0]
            i = len(seq) // 2
            out[0] = (seq[:i] + "ACGT"[("ACGT".index(seq[i]) + 1) % 4] + seq[i + 1 :], depth)
        return out

    mp.setattr(assembler, "traverse_debruijn_graph", traverse)


def _merged_base_flipped(mp):
    """One base of the first merged read changes where the merge makes it."""
    from mhm2_proxy_tpu_torch.models import assembler

    orig = assembler.merge_reads_arrays

    def merge(*a, **kw):
        out = orig(*a, **kw)
        rows = np.nonzero(out["merged"])[0]
        if rows.size:
            out["m_codes"][rows[0], 3] = (out["m_codes"][rows[0], 3] + 1) % 4
        return out

    mp.setattr(assembler, "merge_reads_arrays", merge)


def _record_moved(mp):
    """The first mapped SAM record of each block points one base later."""
    from mhm2_proxy_tpu_torch.models import post_asm

    orig = post_asm.sam_block

    def sam_block(names, out, rows, lens, cnames):
        text = orig(names, out, rows, lens, cnames).split("\n")
        for i, line in enumerate(text):
            f = line.split("\t")
            if len(f) > 3 and f[1] != "4":
                f[3] = str(int(f[3]) + 1)
                text[i] = "\t".join(f)
                break
        return "\n".join(text)

    mp.setattr(post_asm, "sam_block", sam_block)


def _half_the_reads_unaligned(mp):
    """Every other read of a block is left unanchored."""
    from mhm2_proxy_tpu_torch.models import post_asm

    orig = post_asm.align_reads_to_contigs

    def align(codes, lens, *a, **kw):
        out = orig(codes, lens, *a, **kw)
        out["cid"][1::2] = -1
        return out

    mp.setattr(post_asm, "align_reads_to_contigs", align)


def _pass_returns_unchanged(mp):
    """The pass stops after the first read it aligns."""
    from mhm2_proxy_tpu_torch.models import post_asm

    orig = post_asm.post_asm_align

    def post_asm_align(asm, *a, **kw):
        if kw.get("sample_reads") is None:
            kw["sample_reads"] = 0
            kw["block_reads"] = 1
        return orig(asm, *a, **kw)

    mp.setattr(post_asm, "post_asm_align", post_asm_align)


FAULTS = {
    "none": (None, ()),
    "unchanged_state": (_unchanged_last_round, ("round_contigs_differing",
                                                "final_contigs_differing")),
    "half_the_batch": (_half_the_reads, ("round_contigs_differing",)),
    "altered_contig": (_contig_base_flipped, ("round_contigs_differing",)),
    "altered_merge": (_merged_base_flipped, ("merge_pairs_differing",)),
}


def _depth_row_altered(mp):
    """The first contig's depth in the depth table is one higher."""
    from mhm2_proxy_tpu_torch.models import post_asm

    orig = post_asm.post_asm_align

    def post_asm_align(asm, *a, **kw):
        out = orig(asm, *a, **kw)
        path = kw.get("abundance_fname")
        if path and kw.get("sample_reads") is None:
            with open(path) as f:
                lines = f.read().splitlines()
            name, length, depth = lines[1].split("\t")
            lines[1] = f"{name}\t{length}\t{float(depth) + 1:.4f}"
            with open(path, "w") as f:
                f.write("\n".join(lines) + "\n")
        return out

    mp.setattr(post_asm, "post_asm_align", post_asm_align)


POST_ASM_FAULTS = {
    "none": (None, ()),
    "unchanged_state": (_pass_returns_unchanged, ("sam_reads_missing",)),
    "half_the_batch": (_half_the_reads_unaligned, ("sam_records_wrong",)),
    "altered_record": (_record_moved, ("sam_records_wrong",)),
    "altered_depth": (_depth_row_altered, ("depth_rows_wrong",)),
    # the set-up's assembly, which the passes align to
    "altered_assembly": (_contig_base_flipped, ("setup_round_contigs_differing",)),
}
TINY_PARAMS = {"warmup_pairs": 64, "warmup_reads": 512, "check_reads": 400, "check_longest": 16}
CASES = ([(n, "ladder", f) for n in communities.NAMES for f in FAULTS]
         + [("uniform2x100", "post_asm", f) for f in POST_ASM_FAULTS])


@pytest.mark.parametrize("name,traffic,fault", CASES)
def test_planted_fault_is_not_correct(name, traffic, fault, monkeypatch):
    plant, caught_by = (POST_ASM_FAULTS if traffic == "post_asm" else FAULTS)[fault]
    if plant:
        plant(monkeypatch)
    wl = communities.workload(name, traffic, TINY_PARAMS)
    out = run.run_cell(wl["name"], 2**31 + 17, 0, False, device="cpu", require_chip=False,
                       config=tiny(name), workload=wl)
    assert out["correct"] is (plant is None)
    for check in caught_by:
        assert out["checks"][check]["value"] > 0, check
    if plant is None:
        assert all(c["value"] == 0 for c in out["checks"].values())
        assert out["attempted"] == 1 and out["failed"] == 0
