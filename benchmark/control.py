"""The controls of the benchmark's correctness checks, at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

A control is the plain reference put in the program's place, with one of
the configuration's guarantees broken, and it has to come out not correct:

- `ladder` cells: the reference's contigs with depths divided in float32
  (the configuration states float64), judged by the reference itself;
- `post_asm` cells: the program's SAM records with the best scores that an
  alignment saturating at 127 (8-bit cells) gives in place of AS.

Prints one JSON line a seed with the numbers each control reads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def ladder_control(cell: str, seed: int, device) -> dict:
    from benchmark import run
    from benchmark.gen.community import make_community
    from benchmark.reference.assemble import assemble
    from benchmark.traffic.ladder import expected_records, records_diff, reference_reads

    wl = run.load_json("workloads", f"{cell}.json")
    cfg = run.load_json("configs", f"{wl['config']}.json")
    ctx = run.Context(wl, cfg, seed, device, "")
    ctx.state["community"] = make_community(cfg, seed)
    _, reads = reference_reads(ctx, device)
    ks = cfg["kmer_lens"]
    ref = assemble(reads, ks, cfg["min_depth_thres"])
    ctl = assemble(reads, ks, cfg["min_depth_thres"], depth_dtype="float32")
    kmax = ks[-1]
    m = cfg["min_ctg_print_len"]
    return {
        "merge_pairs_differing": 0,
        "round_contigs_differing": sum(records_diff(expected_records(ctl[k]),
                                                    expected_records(ref[k])) for k in ks),
        "final_contigs_differing": records_diff(expected_records(ctl[kmax], m),
                                                expected_records(ref[kmax], m)),
    }


def post_asm_control(cell: str, seed: int, device) -> dict:
    from benchmark import run
    from benchmark.traffic import post_asm

    out = run.run_cell(cell, seed, 0, False, device=device.type,
                       check_fn=lambda ctx, jobs: post_asm.check(ctx, jobs, score_bits=8))
    return {n: c["value"] for n, c in out["checks"].items()}


def main(argv=None) -> int:
    import torch

    from benchmark import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    traffic = run.load_json("workloads", f"{a.workload}.json")["traffic"]
    fn = {"ladder": ladder_control, "post_asm": post_asm_control}[traffic]
    dev = torch.device("cuda")
    for seed in a.seeds:
        t0 = time.perf_counter()
        readings = fn(a.workload, seed, dev)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
