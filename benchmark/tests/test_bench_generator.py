"""The community generator against its configurations (CPU, scaled down
in genome length and pair count, every other parameter as configured)."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from benchmark.gen.community import fastq_bytes, make_community, pairs_per_genome
from benchmark.tests import communities


def config(name: str, genome_len: int = 200_000, pairs: int = 40_000) -> dict:
    cfg = communities.config(name, genome_len=genome_len, pairs=pairs)
    # every genome keeps its configured share
    return dict(cfg, abundances=communities.config(name)["abundances"])


@pytest.mark.parametrize("name", communities.NAMES)
def test_same_seed_same_bytes(name):
    cfg = config(name, 20_000, 2_000)
    a = hashlib.sha256(fastq_bytes(make_community(cfg, 2**31 + 11))).hexdigest()
    b = hashlib.sha256(fastq_bytes(make_community(cfg, 2**31 + 11))).hexdigest()
    c = hashlib.sha256(fastq_bytes(make_community(cfg, 2**31 + 12))).hexdigest()
    assert a == b != c


@pytest.mark.parametrize("name", communities.NAMES)
def test_reads_follow_the_configuration(name):
    cfg = config(name)
    com = make_community(cfg, 7)
    P, L = com.codes1.shape
    assert P == cfg["pairs"] and L == cfg["read_len"] and com.codes2.shape == (P, L)
    ins = com.insert_len.astype(np.float64)
    # the floor at read length + 10 cuts nothing measurable at these means
    assert abs(ins.mean() - cfg["insert_mean"]) < 4 * cfg["insert_sd"] / np.sqrt(P) + 0.5
    assert abs(ins.std() - cfg["insert_sd"]) < 0.05 * cfg["insert_sd"]
    # errors: the bases that differ from their genome, at the configured rate
    bases = 2 * P * L
    rate = com.n_errors / bases
    sd = np.sqrt(cfg["err_rate"] * (1 - cfg["err_rate"]) / bases)
    assert abs(rate - cfg["err_rate"]) < 5 * sd
    low = int((com.quals1 == cfg["qual_lo"]).sum() + (com.quals2 == cfg["qual_lo"]).sum())
    share = cfg["low_qual_share_of_errors"]
    assert abs(low / com.n_errors - share) < 5 * np.sqrt(share * (1 - share) / com.n_errors)


def test_reads_are_the_genome_with_errors():
    cfg = config("uniform2x100", 50_000, 4_000)
    com = make_community(cfg, 3)
    comp = np.array([3, 2, 1, 0], np.uint8)
    L = cfg["read_len"]
    j = np.arange(L)
    n_diff = 0
    for g in range(cfg["genomes"]):
        rows = np.nonzero(com.genome_of_pair == g)[0]
        gen = com.genomes[g]
        s, ins = com.start[rows], com.insert_len[rows].astype(np.int64)
        # read 1 opens the fragment; read 2 is the reverse complement of its end
        r1 = gen[s[:, None] + j]
        r2 = comp[gen[(s + ins - 1)[:, None] - j]]
        n_diff += int((r1 != com.codes1[rows]).sum() + (r2 != com.codes2[rows]).sum())
    assert n_diff == com.n_errors > 0


def test_cami_shares_follow_the_abundances():
    cfg = config("cami_low12")
    com = make_community(cfg, 5)
    share = np.bincount(com.genome_of_pair, minlength=cfg["genomes"]) / com.n_pairs
    ab = np.asarray(cfg["abundances"])
    np.testing.assert_allclose(share, ab / ab.sum(), atol=1.0 / com.n_pairs)
    assert pairs_per_genome(cfg).sum() == cfg["pairs"]
    # the fixed split: every seed draws the same number of pairs a genome
    other = make_community(cfg, 6)
    assert (np.bincount(other.genome_of_pair) == np.bincount(com.genome_of_pair)).all()


def test_three_quarters_of_cami_pairs_overlap():
    cfg = config("cami_low12")
    com = make_community(cfg, 9)
    overlap = 2 * cfg["read_len"] - com.insert_len
    frac = float((overlap >= 12).mean())
    assert 0.70 < frac < 0.80
    uniform = make_community(config("uniform2x100"), 9)
    assert float((2 * 100 - uniform.insert_len >= 12).mean()) < 0.05


def test_fastq_layout():
    cfg = config("uniform2x100", 5_000, 10)
    com = make_community(cfg, 1)
    lines = fastq_bytes(com).decode().splitlines()
    assert len(lines) == 4 * 2 * com.n_pairs
    assert lines[0] == "@p0000000/1" and lines[4] == "@p0000000/2" and lines[2] == "+"
    assert lines[1] == "".join("ACGT"[c] for c in com.codes1[0])
    assert lines[3] == "".join(chr(q + 33) for q in com.quals1[0])
    assert lines[5] == "".join("ACGT"[c] for c in com.codes2[0])
