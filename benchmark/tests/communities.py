"""Configurations and cells of the benchmark's own tests.

Besides the benchmark's configurations (`benchmark/configs/`), the tests
use `uniform2x100`: twelve genomes at one depth, 2x100 bp pairs on 260 bp
inserts, so that few pairs merge and every read keeps its mate. It stands
for no deployment and is no cell; it takes the paths that the configured
communities leave aside. The tests cut every community to a small size.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

UNIFORM = {
    "name": "uniform2x100",
    "genomes": 12,
    "genome_len": 2_250_000,
    "pairs": 1_080_000,
    "abundances": None,
    "read_len": 100,
    "insert_mean": 260,
    "insert_sd": 40,
    "err_rate": 0.002,
    "qual_hi": 38,
    "qual_lo": 5,
    "low_qual_share_of_errors": 0.7,
    "qual_offset": 33,
    "kmer_lens": [21, 33, 55, 77, 99],
    "min_depth_thres": 2,
    "min_ctg_print_len": 500,
}

NAMES = ("uniform2x100", "cami_low12")


def config(name: str, **sizes) -> dict:
    """A configuration by name with its sizes (genomes, genome_len, pairs)
    replaced; abundances are cut to the genomes kept."""
    if name == UNIFORM["name"]:
        cfg = dict(UNIFORM)
    else:
        with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
            cfg = json.load(f)
    cfg.update(sizes)
    if cfg.get("abundances"):
        cfg["abundances"] = cfg["abundances"][: cfg["genomes"]]
    return cfg


def workload(name: str, traffic: str, params: dict) -> dict:
    """A cell of the tests: configuration `name` under traffic `traffic`."""
    return {"name": f"{name}.{traffic}", "config": name, "traffic": traffic, "chips": 1,
            "params": dict(params), "why": "a test of the harness"}
