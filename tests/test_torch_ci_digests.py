"""The reference digests that chip_smoke.py holds the port's CI-sample run to
come from the JAX package: the CI sample (ci/make_sample.py's community,
regenerated as chip_smoke.py does) through the JAX package's CLI with `-k 21
33 --post-asm-align --post-asm-abundance`, then `--post-asm-only` on the
same directory, writes exactly the FASTQ, FASTA, SAM (without @PG) and
depths digests that chip_smoke.py names.

Those digests are the JAX package's at `--block-reads 131072`, the port's
CUDA default. The block size of the ingest sets the SAM's record order
(packed-read order: merged reads, then unmerged mates, block by block); the
counting block changes no output (the FASTA digest below holds at both). So
the ingest runs at 131,072 reads a block and the counting at the CPU
default of 4,096, which on the CPU is minutes faster than 131,072-read
blocks."""

import os

import chip_smoke as S
from mhm2_proxy_tpu.main import run_pipeline as ref_run_pipeline
from mhm2_proxy_tpu.models.assembler import Assembler as RefAssembler
from mhm2_proxy_tpu.options import parse_args as ref_parse_args


def test_chip_smoke_ci_digests_are_the_jax_packages(tmp_path, monkeypatch):
    load_reads = RefAssembler.load_reads

    def load_reads_in_cuda_blocks(self, *args, **kwargs):
        auto, self.cfg.block_reads = self.cfg.block_reads, 131072
        try:
            return load_reads(self, *args, **kwargs)
        finally:
            self.cfg.block_reads = auto

    monkeypatch.setattr(RefAssembler, "load_reads", load_reads_in_cuda_blocks)
    fq, _gens, _n = S.make_community(str(tmp_path / "data"), "synth_sample", 3, 20000, 5000,
                                     18.0, 150, 20260817, False)
    assert S.sha256(fq) == S.CI_FASTQ_SHA256
    out = str(tmp_path / "run")
    ref_run_pipeline(ref_parse_args(["-r", fq, "-k", "21", "33", "-o", out] + S.POST_ASM))
    sam, dep = f"{out}/final_assembly.sam", f"{out}/final_assembly_depths.tsv"
    assert S.sha256(f"{out}/final_assembly.fasta") == S.CI_FASTA_SHA256
    assert (S.sam_digest(sam), S.sha256(dep)) == (S.CI_SAM_SHA256, S.CI_DEPTHS_SHA256)
    os.remove(sam)
    os.remove(dep)
    ref_run_pipeline(ref_parse_args(["-r", fq, "-o", out, "--post-asm-only"] + S.POST_ASM))
    assert (S.sam_digest(sam), S.sha256(dep)) == (S.CI_ONLY_SAM_SHA256,
                                                   S.CI_ONLY_DEPTHS_SHA256)


def test_chip_smoke_shards4_digest_is_the_jax_packages(tmp_path):
    """chip_smoke.py phase 3's `--shards 4` FASTA digest is the JAX package's
    `-k 21 33 --shards 4` on the CI sample (4 of the 8 virtual CPU devices).
    Counting is exact under any split of the reads, so the block size
    changes no contig. It is not the single-device digest: the sharded
    branch keeps every path (no min_ctg_len) and breaks cycles at the least
    (shard, row) node."""
    fq, _gens, _n = S.make_community(str(tmp_path / "data"), "synth_sample", 3, 20000, 5000,
                                     18.0, 150, 20260817, False)
    out = str(tmp_path / "run4")
    ref_run_pipeline(ref_parse_args(["-r", fq, "-k", "21", "33", "-o", out, "--shards", "4"]))
    assert S.sha256(f"{out}/final_assembly.fasta") == S.CI_SHARDS4_FASTA_SHA256
    assert S.CI_SHARDS4_FASTA_SHA256 != S.CI_FASTA_SHA256
