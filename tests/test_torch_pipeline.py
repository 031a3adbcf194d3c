"""The port's assembler on the CPU writes a final_assembly.fasta that is
byte-identical to the JAX reference's `assemble`."""

import numpy as np

from mhm2_proxy_tpu.models import AssemblerConfig as RefConfig
from mhm2_proxy_tpu.models import assemble as ref_assemble
from mhm2_proxy_tpu_torch.io.fastq import write_fastq
from mhm2_proxy_tpu_torch.models import AssemblerConfig, assemble
from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads


def test_fasta_byte_identical(tmp_path):
    rng = np.random.default_rng(2026)
    genome = random_genome(rng, 5000)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=20.0, read_len=100,
                                      insert_mean=180, insert_sd=20, err_rate=0.004)
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, ids, seqs, quals)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_assemble([fq], RefConfig(kmer_lens=(21, 33), output_dir=str(tmp_path / "ref"),
                                 min_ctg_print_len=200))
    asm = assemble([fq], AssemblerConfig(kmer_lens=(21, 33), output_dir=str(tmp_path / "port"),
                                         min_ctg_print_len=200, device="cpu"))
    want = (tmp_path / "ref" / "final_assembly.fasta").read_bytes()
    got = (tmp_path / "port" / "final_assembly.fasta").read_bytes()
    assert len(want) > 4000 and got == want
    assert asm.round_stats[33]["ctg_rule_rows"] > 0


def test_fasta_byte_identical_default_ladder(tmp_path):
    """The default k ladder (21, 33, 55, 77, 99): k = 63/77's separate
    payload layout and every round's contig pass, on the CPU."""
    rng = np.random.default_rng(77)
    genome = random_genome(rng, 4000)
    ids, seqs, quals = simulate_reads(rng, genome, coverage=25.0, read_len=100,
                                      insert_mean=180, insert_sd=20, err_rate=0.004)
    fq = str(tmp_path / "reads.fastq")
    write_fastq(fq, ids, seqs, quals)
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_assemble([fq], RefConfig(output_dir=str(tmp_path / "ref"), min_ctg_print_len=200))
    asm = assemble([fq], AssemblerConfig(output_dir=str(tmp_path / "port"),
                                         min_ctg_print_len=200, device="cpu"))
    assert asm.cfg.kmer_lens == (21, 33, 55, 77, 99)
    assert sorted(asm.round_stats) == [21, 33, 55, 77, 99]
    want = (tmp_path / "ref" / "final_assembly.fasta").read_bytes()
    got = (tmp_path / "port" / "final_assembly.fasta").read_bytes()
    assert len(want) > 3000 and got == want
    assert all(asm.round_stats[k]["ctg_rule_rows"] > 0 for k in (33, 55, 77, 99))
