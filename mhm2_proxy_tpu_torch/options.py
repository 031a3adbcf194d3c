"""CLI options and config round-trip (reference src/options.{hpp,cpp}).

Same surface as mhm2_proxy_tpu.options plus --device (default cuda).

Mirrors the reference's CLI surface (options.cpp:253-459): reads specs,
k progression, depth threshold, checkpointing, restart, kmer dumps, output
dir handling, and a config file that records every option and can be reloaded
(`--config`, options.cpp:448-456). The config format is JSON instead of INI.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from .constants import DEFAULT_KMER_LENS, DEFAULT_MIN_CTG_PRINT_LEN, DEFAULT_QUAL_OFFSET


@dataclasses.dataclass
class Options:
    reads: list = dataclasses.field(default_factory=list)  # interleaved or 'f1:f2'
    unpaired: list = dataclasses.field(default_factory=list)
    kmer_lens: list = dataclasses.field(default_factory=lambda: list(DEFAULT_KMER_LENS))
    min_depth_thres: int = 2
    qual_offset: int = DEFAULT_QUAL_OFFSET
    output_dir: str = ""
    checkpoint: bool = True
    checkpoint_merged: bool = False
    dump_kmers: bool = False
    restart: bool = False
    # mid-pipeline restart from an EXTERNAL contig set (reference
    # docs/mhm_guide.md:285-309, options.hpp:88-107): contigs = FASTA used
    # as the most recent checkpoint; prev_kmer_len = the k of the round that
    # produced it (rounds with k <= prev_kmer_len are skipped; 0 = infer
    # from a contigs-<k>.fasta filename); max_kmer_len = largest contigging
    # k of the ORIGINAL run (GFA overlap sizing when this run only re-runs
    # smaller k; 0 = max of this run's kmer_lens)
    contigs: str = ""
    prev_kmer_len: int = 0
    max_kmer_len: int = 0
    min_ctg_print_len: int = DEFAULT_MIN_CTG_PRINT_LEN
    block_reads: int = 0  # 0 = auto (131072 on CUDA, 4096 on CPU)
    bucket_cap: int = 0  # 0 = auto; per-destination exchange bucket rows
    shards: int = 0
    hosts: int = 0  # >1: (hosts, shards/hosts) dcn x ici mesh
    verbose: bool = False
    gfa: bool = False
    profile: bool = False
    post_asm_align: bool = False
    post_asm_abundance: bool = False
    post_asm_only: bool = False
    device: str = "cuda"

    def save(self, fname: str):
        with open(fname, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @staticmethod
    def load_config(fname: str) -> "Options":
        with open(fname) as f:
            return Options(**json.load(f))


def parse_args(argv=None) -> Options:
    p = argparse.ArgumentParser(
        prog="mhm2_torch",
        description="PyTorch/CUDA metagenome contigging (MHM2 proxy capability set)",
    )
    p.add_argument("-r", "--reads", nargs="+", default=[],
                   help="interleaved FASTQ files or paired as file1:file2")
    p.add_argument("-u", "--unpaired", nargs="+", default=[], help="unpaired FASTQ files")
    p.add_argument("-k", "--kmer-lens", type=int, nargs="+",
                   default=list(DEFAULT_KMER_LENS), help="k-mer length progression")
    p.add_argument("--min-depth-thres", type=int, default=2,
                   help="minimum depth for distinct extension calls")
    p.add_argument("-Q", "--quality-offset", type=int, default=DEFAULT_QUAL_OFFSET,
                   choices=(33, 64))
    p.add_argument("-o", "--output", default="", help="output directory")
    p.add_argument("--checkpoint", action=argparse.BooleanOptionalAction, default=True,
                   help="write contigs-<k>.fasta each round")
    p.add_argument("--checkpoint-merged", action="store_true",
                   help="write merged reads FASTQ checkpoints")
    p.add_argument("--dump-kmers", action="store_true",
                   help="write kmers-<k>.txt.gz per round")
    p.add_argument("--restart", action="store_true",
                   help="resume in an existing output dir at the first missing round")
    p.add_argument("-c", "--contigs", default="",
                   help="FASTA contig file to use as the most recent "
                        "checkpoint for a mid-pipeline restart (any "
                        "contigs-<k>.fasta from a checkpointed run; reference "
                        "mhm_guide.md:285-309)")
    p.add_argument("--prev-kmer-len", type=int, default=0,
                   help="k of the round that produced --contigs; rounds with "
                        "k <= this are skipped. 0 = infer from a "
                        "contigs-<k>.fasta filename")
    p.add_argument("--max-kmer-len", type=int, default=0,
                   help="largest contigging k of the original run (sizes GFA "
                        "overlaps when this run only re-runs smaller k); "
                        "0 = max of this run's -k list")
    p.add_argument("-s", "--scaff-kmer-lens", nargs="+", default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--min-ctg-print-len", type=int, default=DEFAULT_MIN_CTG_PRINT_LEN)
    p.add_argument("--block-reads", type=int, default=0,
                   help="reads per device block; 0 = auto (131072 on CUDA, "
                        "4096 on CPU)")
    p.add_argument("--bucket-cap", type=int, default=0,
                   help="per-destination exchange bucket capacity in records "
                        "for sharded counting; 0 = auto-sized from block "
                        "volume. Raise it if skew warnings report spill "
                        "rounds (analog of --max-kmer-store, options.cpp)")
    p.add_argument("--shards", type=int, default=0,
                   help=">0: shard counting/traversal over this many shards, "
                        "all on the run's one device")
    p.add_argument("--hosts", type=int, default=0,
                   help=">1: arrange shards as a (hosts, shards/hosts) dcn x ici "
                        "mesh with node-aware hierarchical exchange")
    p.add_argument("--gfa", action="store_true", help="write final_assembly.gfa2")
    p.add_argument("--profile", action="store_true",
                   help="capture a profiler trace of the first round")
    p.add_argument("--post-asm-align", action="store_true",
                   help="align all reads back to the final assembly; writes "
                        "final_assembly.sam (docs/mhm_guide.md:211-221)")
    p.add_argument("--post-asm-abundance", "--post-asm-abd", action="store_true",
                   dest="post_asm_abundance",
                   help="compute per-contig depths from read alignments; writes "
                        "final_assembly_depths.tsv (docs/mhm_guide.md:215-225)")
    p.add_argument("--post-asm-only", action="store_true",
                   help="run only the post-assembly steps on the existing "
                        "final_assembly.fasta in the output dir "
                        "(docs/mhm_guide.md:226-233)")
    p.add_argument("--config", default=None, help="load options from a config file")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "silent CPU fallback)")
    a = p.parse_args(argv)

    if a.scaff_kmer_lens is not None:
        # explicit rejection, not silent: scaffolding rounds are outside the
        # contigging-proxy capability set this framework mirrors (the
        # reference proxy ends at final contigs too); see docs/guide.md
        p.error(
            "-s/--scaff-kmer-lens: scaffolding is outside the contigging "
            "proxy's scope (the pipeline ends at final_assembly.fasta); "
            "see docs/guide.md 'Reference flag mapping'"
        )

    if a.contigs and not os.path.exists(a.contigs):
        p.error(f"--contigs: {a.contigs} not found")

    if a.config:
        opts = Options.load_config(a.config)
        # CLI restart flag still applies on top of a loaded config
        if a.restart:
            opts.restart = True
        return opts

    if not a.reads and not a.unpaired and not a.restart:
        p.error("at least one of --reads/--unpaired (or --restart with --config) is required")

    return Options(
        reads=a.reads,
        unpaired=a.unpaired,
        kmer_lens=a.kmer_lens,
        min_depth_thres=a.min_depth_thres,
        qual_offset=a.quality_offset,
        output_dir=a.output,
        checkpoint=a.checkpoint,
        checkpoint_merged=a.checkpoint_merged,
        dump_kmers=a.dump_kmers,
        restart=a.restart,
        contigs=a.contigs,
        prev_kmer_len=a.prev_kmer_len,
        max_kmer_len=a.max_kmer_len,
        min_ctg_print_len=a.min_ctg_print_len,
        block_reads=a.block_reads,
        bucket_cap=a.bucket_cap,
        shards=a.shards,
        hosts=a.hosts,
        verbose=a.verbose,
        gfa=a.gfa,
        profile=a.profile,
        post_asm_align=a.post_asm_align,
        post_asm_abundance=a.post_asm_abundance,
        post_asm_only=a.post_asm_only,
        device=a.device,
    )


def setup_output_dir(opts: Options) -> str:
    """Create/enter the output dir (reference options.cpp:89-200)."""
    out = opts.output_dir
    if not out:
        base = os.path.basename(opts.reads[0].split(":")[0]) if opts.reads else "run"
        out = "mhm2_torch-run-" + os.path.splitext(base)[0]
    os.makedirs(out, exist_ok=True)
    return out
