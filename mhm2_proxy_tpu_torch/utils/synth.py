"""Synthetic metagenome data for tests and benchmarks.

The reference validates against a downloaded ArcticSynth sample
(ci/ci_asm_qual_test.sh); with no network access we generate synthetic
genomes + Illumina-like paired reads and gate on recovery metrics against the
known ground truth instead.
"""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def random_genome(rng: np.random.Generator, length: int) -> str:
    return BASES[rng.integers(0, 4, length)].tobytes().decode()


def simulate_reads(
    rng: np.random.Generator,
    genome: str,
    coverage: float = 20.0,
    read_len: int = 100,
    insert_mean: int = 250,
    insert_sd: int = 30,
    err_rate: float = 0.005,
    qual_hi: int = 38,
    qual_lo: int = 5,
):
    """Paired-end reads (fwd, rc-rev) with per-base errors and quals.

    Returns (ids, seqs, quals) lists for an interleaved FASTQ: records
    alternate /1, /2. Error positions get low quality with probability 0.7
    (so some errors look high-quality, like real data).
    """
    g = np.frombuffer(genome.encode(), np.uint8)
    G = len(g)
    n_pairs = max(1, int(G * coverage / (2 * read_len)))
    ids, seqs, quals = [], [], []
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGTN", b"TGCAN"):
        comp[a] = b
    for p in range(n_pairs):
        # inserts below 2*read_len make the pair overlap (the merge path);
        # the floor only guarantees both mates fit inside the fragment
        ins = max(read_len + 10, int(rng.normal(insert_mean, insert_sd)))
        start = int(rng.integers(0, max(1, G - ins)))
        frag = g[start : start + ins]
        r1 = frag[:read_len].copy()
        r2 = comp[frag[-read_len:][::-1]].copy()
        q1 = np.full(read_len, qual_hi, np.uint8)
        q2 = np.full(read_len, qual_hi, np.uint8)
        for r, q in ((r1, q1), (r2, q2)):
            errs = np.nonzero(rng.random(len(r)) < err_rate)[0]
            for e in errs:
                r[e] = BASES[(np.searchsorted(BASES, r[e]) + rng.integers(1, 4)) % 4]
                if rng.random() < 0.7:
                    q[e] = qual_lo
        ids.append(f"pair{p}/1".encode())
        seqs.append(r1.tobytes())
        quals.append((q1 + 33).tobytes())
        ids.append(f"pair{p}/2".encode())
        seqs.append(r2.tobytes())
        quals.append((q2 + 33).tobytes())
    return ids, seqs, quals
