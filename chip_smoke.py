#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (mhm2_proxy_tpu_torch).

    python3 chip_smoke.py            # every phase, one GPU

Phases (any failure raises, and the script exits non-zero):
  1. the card (nvidia-smi name and power limit), torch/CUDA versions, and the
     build of the five CUDA kernels from csrc/;
  2. each kernel against its plain PyTorch version on CUDA tensors at the
     main path's shapes, bit-exact (integers, tolerance 0), with times; and
     the count store + traversal on CUDA against the same on the CPU at
     k = 21, 33, 55, 99 (every instantiation of the kernels' templates);
  3. the CI sample (ci/make_sample.py's default community, regenerated with
     the port's synth) end to end through the CLI entry point, checked
     against the JAX package's FASTA digest and ci/good-synth-sample-k2133.txt;
  4. a real-size run: the --arctic-scale community cut to 3 genomes
     (6.75 Mbp, 8x, 100 bp pairs), all five launch counts > 0 and >= 95% of
     the assembled bases in exact substrings of the genomes.
Prints the kernels' JSON summary, then the card line, then as the last line
{"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no result.
Work files go to chip_smoke_work/ next to this script (removed at the end).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# sha256 digests, from the JAX package on the CPU (see CHANGES.md)
CI_FASTQ_SHA256 = "d0409d7f481511021635839eb02cc4c264371be2afda1f68b8e5f4e85a817c98"
CI_FASTA_SHA256 = "a17c6e42edf61813c7d47128a0efa75f6461930485cc80dfbe31152ce664b2f3"
ARCTIC3_FASTQ_SHA256 = "491bd9fb910e892ec85dc9dd8d8358aaaddc598794d4b6f1aaa78b08cf43be15"
ARCTIC3_FASTA_SHA256 = "b9863311bb0099aea359a6dbeb623bce8910e665ca86a2f609f1a4242219a2bb"


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    """A failed check ends the run (explicit, so `python -O` keeps it)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def make_community(out_dir, name, genomes, genome_len, step, coverage, read_len, seed, arctic):
    """ci/make_sample.py's generator (same rng call order) on the port's
    synth: genome FASTAs + one interleaved paired FASTQ."""
    import numpy as np

    from mhm2_proxy_tpu_torch.io.fasta import write_fasta
    from mhm2_proxy_tpu_torch.io.fastq import write_fastq
    from mhm2_proxy_tpu_torch.utils.synth import random_genome, simulate_reads

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    all_ids, all_seqs, all_quals, gens = [], [], [], []
    for g in range(genomes):
        cov = coverage if arctic else coverage * (1.0 + 0.5 * (g % 4))
        genome = random_genome(rng, genome_len + step * g)
        gens.append(genome)
        write_fasta(os.path.join(out_dir, f"{name}-genome{g}.fasta"), [(g, genome, 1.0)])
        ids, seqs, quals = simulate_reads(
            rng, genome, coverage=cov, read_len=read_len, insert_mean=260, insert_sd=40,
            err_rate=0.002 if arctic else 0.004,
        )
        all_ids.extend(f"g{g}.{i.decode()}".encode() for i in ids)
        all_seqs.extend(seqs)
        all_quals.extend(quals)
    order = rng.permutation(len(all_seqs) // 2)
    ids, seqs, quals = [], [], []
    for p in order:
        for j in (0, 1):
            ids.append(all_ids[2 * p + j])
            seqs.append(all_seqs[2 * p + j])
            quals.append(all_quals[2 * p + j])
    fq = os.path.join(out_dir, f"{name}.fastq")
    write_fastq(fq, ids, seqs, quals)
    return fq, gens, len(order)


def read_fasta_seqs(path):
    from mhm2_proxy_tpu_torch.io.fasta import read_fasta

    return [s for _, s in read_fasta(path)]


def asm_metrics(seqs):
    lens = sorted((len(s) for s in seqs), reverse=True)
    tot = sum(lens)
    acc, n50 = 0, 0
    for ln in lens:
        acc += ln
        if acc >= tot / 2:
            n50 = ln
            break
    return dict(num_contigs=len(lens), total_length=tot,
                largest_contig=lens[0] if lens else 0, n50=n50)


def parse_run_log(path):
    """Per-k counting lines and [module] wall times from mhm2_torch.log."""
    rounds, modules = {}, {}
    pat = re.compile(r"k=(\d+): counted (\d+) kmers from (\d+) blocks in [\d.]+s "
                     r"\(raw rows (\d+), raw bytes (\d+), ctg-rule rows (\d+)\)")
    for line in open(path):
        m = pat.search(line)
        if m:
            k, kmers, blocks, rows, nbytes, ctg = map(int, m.groups())
            rounds[k] = dict(kmers=kmers, blocks=blocks, raw_rows=rows, raw_bytes=nbytes,
                             ctg_rule_rows=ctg)
        m = re.search(r"\[module\] (.+) ([\d.]+)s$", line.strip())
        if m:
            modules[m.group(1)] = float(m.group(2))
    return rounds, modules


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_err(a, b) -> int:
    """Max |a - b| over int32 lane tuples read as u32 (shapes must match)."""
    from mhm2_proxy_tpu_torch.ops.u32 import widen

    a, b = tuple(a), tuple(b)
    check(len(a) == len(b), (len(a), len(b)))
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape, (x.shape, y.shape))
        if x.numel():
            err = max(err, int((widen(x) - widen(y)).abs().max()))
    return err


def random_sorted_run(n, n_lanes, kw, gen, dup_from=None, sent_frac=0.02):
    """A lexsorted run: random u32 keys (bit 31 set on about half), a tail of
    all-ones sentinels, optional keys copied from `dup_from` (equal keys
    across the two runs), random non-key lanes."""
    import torch

    from mhm2_proxy_tpu_torch.ops.u32 import lexsort_lanes

    dev = "cuda"
    lanes = [torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
             for _ in range(n_lanes)]
    if dup_from is not None and n:
        m = dup_from[0].shape[0]
        pick = torch.randint(0, max(m, 1), (n // 2,), device=dev, generator=gen)
        for i in range(kw):
            lanes[i][: n // 2] = dup_from[i][pick]
    n_sent = int(n * sent_frac)
    for i in range(kw):
        lanes[i][n - n_sent:] = -1
    return lexsort_lanes(tuple(lanes), kw)


def sim_read_block(genome_codes, B, L, read_len, gen):
    """B reads of read_len bases at random genome positions with 0.2% base
    errors and 5% low-quality bases, padded to L (device tensors)."""
    import torch

    dev = "cuda"
    G = genome_codes.shape[0]
    start = torch.randint(0, G - read_len, (B,), device=dev, generator=gen)
    idx = start[:, None] + torch.arange(read_len, device=dev)[None, :]
    reads = genome_codes[idx]
    err = torch.rand((B, read_len), device=dev, generator=gen) < 0.002
    shift = torch.randint(1, 4, (B, read_len), device=dev, generator=gen, dtype=torch.uint8)
    reads = torch.where(err, (reads + shift) % 4, reads)
    codes = torch.full((B, L), 4, dtype=torch.uint8, device=dev)
    codes[:, :read_len] = reads
    qual = torch.rand((B, L), device=dev, generator=gen) > 0.05
    lens = torch.full((B,), read_len, dtype=torch.int32, device=dev)
    return codes, qual, lens


def phase_kernels(results):
    import torch

    from mhm2_proxy_tpu_torch.ops import compact, extract, finalize, join, lookup, sort
    from mhm2_proxy_tpu_torch.ops.u32 import lexsort_lanes, narrow

    gen = torch.Generator(device="cuda")
    gen.manual_seed(20260817)
    dev = "cuda"

    def record(name, err, ms, plain_ms, what):
        log(f"[kernel] {name:8s} {what}: max_abs_err={err} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(err == 0, f"{name} disagrees with its plain version ({what}): max_abs_err={err}")
        r = results.setdefault(name, dict(max_abs_err=0, ms=None, plain_ms=None, shape=what))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if r["ms"] is None:  # the first, main-path-shape measurement is reported
            r.update(ms=ms, plain_ms=plain_ms, shape=what)

    # extract: read blocks (131072, 128), packed, k = 21 and 33; contig
    # windows (2048, 2048) in the record layout
    for k, (B, L), packed in ((21, (131072, 128), True), (33, (131072, 128), True),
                              (33, (2048, 2048), False)):
        codes = torch.randint(0, 5, (B, L), dtype=torch.uint8, device=dev, generator=gen)
        qual = torch.rand((B, L), device=dev, generator=gen) > 0.05
        lens = torch.randint(k - 2, L + 1, (B,), dtype=torch.int32, device=dev, generator=gen)
        kern = lambda: extract._extract(codes, qual, lens, k, packed)  # noqa: E731
        plain = lambda: extract._extract_plain(codes, qual, lens, k, packed)  # noqa: E731
        err = max_abs_err(kern(), plain())
        record("extract", err, cuda_ms(kern), cuda_ms(plain),
               f"({B}, {L}) k={k} {'packed' if packed else 'record'}")

    # sort: the 1120-tile merge (7,340,032 + 29,360,128 rows = 36,700,160),
    # two odd-length merges, and the pad_fill variant at a join shape
    cases = [
        ("1120-tile merge 7340032+29360128 kw=2", 7_340_032, 29_360_128, 2, 2, None),
        ("odd merge 1000003+2999999 kw=3", 1_000_003, 2_999_999, 3, 3, None),
        ("odd merge 12345+1 kw=2 +1 payload", 12_345, 1, 2, 3, None),
        ("pad_fill merge 7000001+14000002 kw=4 +1 payload", 7_000_001, 14_000_002, 4, 5,
         (0x01FFFFFF,)),
    ]
    for what, na, nb, kw, n_lanes, fill in cases:
        a = random_sorted_run(na, n_lanes, kw, gen)
        b = random_sorted_run(nb, n_lanes, kw, gen, dup_from=a)
        total = na + nb
        n_out = -(-total // sort.TILE) * sort.TILE if fill else total
        fl = [-1] * kw + [x - (1 << 32) if x >= 1 << 31 else x for x in (fill or [0] * (n_lanes - kw))]
        kern = lambda: sort._merge_cuda(a, b, kw, n_out, fl)  # noqa: E731
        plain = lambda: sort._merge_plain(a, b, kw, n_out, fl)  # noqa: E731
        err = max_abs_err(kern(), plain())
        record("sort", err, cuda_ms(kern), cuda_ms(plain), what)
        del a, b

    # finalize: purge True and False over a merged run of two extracted read
    # blocks (131072 x 100 bp reads of a 2.25 Mbp genome)
    genome = torch.randint(0, 4, (2_250_000,), dtype=torch.uint8, device=dev, generator=gen)
    runs = []
    for _ in range(2):
        codes, qual, lens = sim_read_block(genome, 131072, 128, 100, gen)
        runs.append(lexsort_lanes(extract._extract(codes, qual, lens, 21, True)))
    merged = sort.merge_sorted_lanes(runs[0], runs[1], 2)
    for purge in (True, False):
        kern = lambda: finalize._scan_purge_cuda(merged, finalize._keymask(21, 2), 2, purge)  # noqa: E731
        plain = lambda: finalize._scan_purge_plain(merged, finalize._keymask(21, 2), 2, purge)  # noqa: E731
        (kd, kf), (pd, pf) = kern(), plain()
        err = max(max_abs_err(kd, pd), max_abs_err((kf,), (pf,)))
        record("finalize", err, cuda_ms(kern), cuda_ms(plain),
               f"{merged[0].shape[0]} rows k=21 purge={purge}")
    del runs, merged

    # compact: 2-class at 36,700,160 rows, 3 lanes, emit class 0
    N = 36_700_160
    lanes = tuple(torch.randint(-2**31, 2**31, (N,), dtype=torch.int32, device=dev, generator=gen)
                  for _ in range(3))
    flags = (torch.rand((N,), device=dev, generator=gen) > 0.2).to(torch.int32)
    kern = lambda: compact._compact_cuda(lanes, flags, 2, (0,))  # noqa: E731
    plain = lambda: compact._compact_plain(lanes, flags, (0,))  # noqa: E731
    ((ko, kn),), ((po, pn),) = kern(), plain()
    n = int(pn)
    err = abs(int(kn) - n) + max_abs_err(tuple(x[:n] for x in ko), tuple(x[:n] for x in po))
    record("compact", err, cuda_ms(kern), cuda_ms(plain), f"{N} rows 2-class")
    del lanes, flags

    # join: the k=21 edge join at the real-size community's shape: a table
    # of 7,340,032 rows (6,636,069 valid), two queries per row (70% hits,
    # 10% all-ones), a 6-bit payload
    T, n_valid = 7_340_032, 6_636_069
    Q = 2 * T
    keys = torch.unique(torch.randint(0, 1 << 42, (T + T // 8,), device=dev, generator=gen))[:T]
    check(keys.shape[0] == T, "join: too few distinct table keys")

    def key_words(kk):
        return torch.stack([narrow(kk >> 10), narrow((kk & 0x3FF) << 22)], 1)

    words = key_words(keys)
    words[n_valid:] = -1
    n_hit, n_sent = Q * 7 // 10, Q // 10
    qk = torch.cat([keys[torch.randint(0, n_valid, (n_hit,), device=dev, generator=gen)],
                    torch.randint(0, 1 << 42, (Q - n_hit - n_sent,), device=dev, generator=gen)])
    qw = torch.cat([key_words(qk), torch.full((n_sent, 2), -1, dtype=torch.int32, device=dev)])
    qw = qw[torch.randperm(Q, device=dev, generator=gen)]
    payload = torch.randint(0, 64, (T,), device=dev, generator=gen)
    merged = lookup.merged_join_rows(words, qw, payload)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=dev)
    kern = lambda: join._propagate_cuda(merged, nv, 2, 6, Q, 32)  # noqa: E731
    plain = lambda: join._propagate_plain(merged, nv, 2, 6, Q, 32)  # noqa: E731
    ka, pa = kern(), plain()
    hits = int((pa != 0).sum())
    check(n_hit <= hits < Q - n_sent, f"join: {hits} answers for {n_hit} hit queries")
    record("join", max_abs_err((ka,), (pa,)), cuda_ms(kern), cuda_ms(plain),
           f"{merged[0].shape[0]} merged rows ({T} table, {Q} queries) kw=2")


def phase_devices():
    """KmerCountStore (reads + a contig pass) and the traversal on CUDA equal
    the same on the CPU (plain versions), table and contigs, at every k the
    slice supports."""
    import numpy as np

    from mhm2_proxy_tpu_torch.dbjg import traverse_debruijn_graph
    from mhm2_proxy_tpu_torch.kcount import KmerCountStore

    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, 20000).astype(np.uint8)
    for k in (21, 33, 55, 99):
        t0 = time.perf_counter()
        blocks = []
        for _ in range(2):
            B, L = 3000, 160
            start = rng.integers(0, genome.size - L, B)
            codes = genome[start[:, None] + np.arange(L)[None, :]]
            err = rng.random(codes.shape) < 0.003
            codes = np.where(err, rng.integers(0, 5, codes.shape), codes).astype(np.uint8)
            lens = rng.integers(k - 2, L + 1, B).astype(np.int32)
            codes[np.arange(L)[None, :] >= lens[:, None]] = 4
            blocks.append((codes, rng.random(codes.shape) > 0.05, lens))
        n_ctg, seg = 24, 2048
        c_start = rng.integers(0, genome.size - seg, n_ctg)
        c_codes = genome[c_start[:, None] + np.arange(seg)[None, :]].astype(np.uint8)
        c_lens = rng.integers(k + 2, seg + 1, n_ctg).astype(np.int32)
        c_codes[np.arange(seg)[None, :] >= c_lens[:, None]] = 4
        c_deps = rng.integers(1, 50, n_ctg).astype(np.int32)
        got = {}
        for dev in ("cpu", "cuda"):
            st = KmerCountStore(k, device=dev)
            for blk in blocks:
                st.add_reads_block(*blk)
            st.add_ctgs_block(c_codes, c_lens, c_deps)
            table = st.finalize()
            w, c, l, r, n = table.to_numpy()
            got[dev] = ((w[:n], c[:n], l[:n], r[:n]), sorted(traverse_debruijn_graph(table, k)))
        (tc, cc), (tg, cg) = got["cpu"], got["cuda"]
        same = all(np.array_equal(x, y) for x, y in zip(tc, tg)) and cc == cg
        log(f"[devices] k={k}: {len(tc[0])} table rows, {len(cc)} contigs, "
            f"CUDA == CPU: {same} ({time.perf_counter() - t0:.1f} s)")
        check(same and len(tc[0]) > 0 and len(cc) > 0, f"k={k}: CUDA and CPU results differ")


# ---------------------------------------------------------------------------
# phases 3 and 4: the CLI end to end
# ---------------------------------------------------------------------------


def run_cli(fq, out_dir, ks):
    from mhm2_proxy_tpu_torch.main import main as cli_main
    from mhm2_proxy_tpu_torch.ops import kernels

    shutil.rmtree(out_dir, ignore_errors=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    rc = cli_main(["-r", fq, "-k", *map(str, ks), "-o", out_dir])
    import torch

    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    check(rc == 0, rc)
    return wall, counts


def phase_ci(work):
    d = os.path.join(work, "ci_data")
    fq, _gens, n_pairs = make_community(d, "synth_sample", 3, 20000, 5000, 18.0, 150,
                                        20260817, False)
    digest = sha256(fq)
    log(f"[ci] {n_pairs} pairs, fastq sha256 {digest}")
    check(digest == CI_FASTQ_SHA256, "CI sample FASTQ differs from ci/make_sample.py's (numpy drift)")
    out = os.path.join(work, "ci_run")
    wall, counts = run_cli(fq, out, (21, 33))
    fa = os.path.join(out, "final_assembly.fasta")
    fdig = sha256(fa)
    log(f"[ci] wall {wall:.2f} s, launches {counts}, final_assembly.fasta sha256 {fdig}")
    check(fdig == CI_FASTA_SHA256, "final_assembly.fasta differs from the JAX package's")
    golden = {}
    for line in open(os.path.join(ROOT, "ci", "good-synth-sample-k2133.txt")):
        m = re.match(r"(\w+) = ([\d.]+)", line.strip())
        if m:
            golden[m.group(1)] = float(m.group(2))
    got = asm_metrics(read_fasta_seqs(fa))
    for key, v in got.items():
        check(v == golden[key], f"{key}: {v} vs golden {golden[key]}")
    log(f"[ci] metrics {got} match ci/good-synth-sample-k2133.txt")
    check(all(counts[k] > 0 for k in counts), counts)


def phase_real(work):
    d = os.path.join(work, "arctic3")
    t0 = time.perf_counter()
    fq, gens, n_pairs = make_community(d, "arctic-scale", 3, 2_250_000, 0, 8.0, 100, 12, True)
    digest = sha256(fq)
    log(f"[real] {sum(map(len, gens))} bp in 3 genomes, {n_pairs} pairs "
        f"({2 * n_pairs} reads), fastq sha256 {digest}, generated in "
        f"{time.perf_counter() - t0:.1f} s")
    check(digest == ARCTIC3_FASTQ_SHA256, "arctic-scale FASTQ differs (numpy drift)")
    out = os.path.join(work, "arctic3_run")
    wall, counts = run_cli(fq, out, (21, 33))
    rounds, modules = parse_run_log(os.path.join(out, "mhm2_torch.log"))
    for k, r in sorted(rounds.items()):
        log(f"[real] k={k}: {r['blocks']} blocks, raw rows {r['raw_rows']} "
            f"({r['raw_bytes'] / 1e9:.3f} GB merged), ctg-rule rows {r['ctg_rule_rows']}, "
            f"table rows {r['kmers']}")
    for name, secs in modules.items():
        log(f"[real] stage {name}: {secs:.2f} s")
    log(f"[real] wall {wall:.2f} s, launches {counts}")
    check(all(counts[k] > 0 for k in counts), f"a kernel of the path never launched: {counts}")
    fa = os.path.join(out, "final_assembly.fasta")
    seqs = read_fasta_seqs(fa)
    from mhm2_proxy_tpu_torch.io.gfa import revcomp_str

    gplus = "$".join(gens + [revcomp_str(g) for g in gens])
    tot = sum(map(len, seqs))
    match = sum(len(s) for s in seqs if s in gplus)
    frac = match / max(tot, 1)
    fdig = sha256(fa)
    log(f"[real] {asm_metrics(seqs)}; exact-substring bases {match}/{tot} = {frac:.4f}; "
        f"final_assembly.fasta sha256 {fdig}")
    check(tot > 0 and frac >= 0.95, frac)
    check(fdig == ARCTIC3_FASTA_SHA256, "final_assembly.fasta differs from the JAX package's")
    return counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from mhm2_proxy_tpu_torch.ops import _build, kernels

    card = card_line()
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 'cached'}), "
        f"{_build.library_path}")
    work = os.path.join(ROOT, "chip_smoke_work")
    results: dict = {}
    try:
        phase_kernels(results)
        phase_devices()
        phase_ci(work)
        counts = phase_real(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = []
    for name, (src, replaces) in kernels.KERNELS.items():
        r = results[name]
        summary.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=counts[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], shape=r["shape"]))
    log(json.dumps({"kernels": summary}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
