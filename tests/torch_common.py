"""Shared pieces of the port's tests (imports torch and pytest, never jax, so
the card-only tests and chip_smoke.py can use it too)."""

import os

import numpy as np
import pytest
import torch

# the reference's three Smith-Waterman scoring profiles (tests/test_ssw.py)
# and one with gap_open < gap_extend, where the lazy F differs from the
# textbook F over H
SCORINGS_ALL = [
    dict(match=2, mismatch=2, gap_open=3, gap_extend=1, ambiguity=2),
    dict(match=1, mismatch=1, gap_open=1, gap_extend=1, ambiguity=1),
    dict(match=2, mismatch=4, gap_open=4, gap_extend=2, ambiguity=1),
    dict(match=2, mismatch=3, gap_open=1, gap_extend=3, ambiguity=1),
]
# a mismatch score past a signed byte: the CUDA kernel's compare-and-select
# substitution (it permutes score bytes when match, -mismatch and -ambiguity
# all fit one)
SCORING_WIDE = dict(match=2, mismatch=200, gap_open=3, gap_extend=1, ambiguity=2)


# the range cuts' cases: R sorted runs of word 0 (u32), drawn by
# range_cut_runs
RANGE_CUT_CASES = ("top_bit", "duplicates", "all_equal", "empty_parts", "no_rows", "strided")


def range_cut_runs(case, rng, R=4, rows=3000, W=3, device="cpu"):
    """(lanes, counts, words): R runs as int32 column-0 views of (n, W)
    row-major words sorted on word 0 as u32, whose rows past counts[j] are
    all-ones sentinels (counts[j] live rows); words[j] is run j's live word
    0 as a numpy uint32 array. top_bit: about half the keys with bit 31
    set; duplicates: 50 distinct keys; all_equal: one key; empty_parts:
    every other run has no live row; no_rows: none has; strided: W = 5
    words and sentinel tails, counts given as 0-dim tensors. The words
    lie on `device`."""
    lanes, counts, words = [], [], []
    for j in range(R):
        n = int(rng.integers(rows // 2, rows + 1))
        if case == "no_rows" or (case == "empty_parts" and j % 2 == 0):
            n = 0
        if case == "duplicates":
            keys = rng.choice(rng.integers(0, 1 << 32, 50, dtype=np.uint64), n)
        elif case == "all_equal":
            keys = np.full(n, 0x9E3779B9, np.uint64)
        else:
            keys = rng.integers(0, 1 << 32, n, dtype=np.uint64)
            keys[: n // 2] |= 1 << 31
        tail = int(rng.integers(1, 40)) if case == "strided" else 0
        w = rng.integers(0, 1 << 32, (n + tail, 5 if case == "strided" else W), dtype=np.uint64)
        w[:n, 0] = np.sort(keys)
        w[n:] = 0xFFFFFFFF
        t = torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(device)
        lanes.append(t[:, 0])
        counts.append(torch.tensor(n, dtype=torch.int32, device=device) if case == "strided"
                      else n)
        words.append(w[:n, 0].astype(np.uint32))
    return lanes, counts, words


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run long loops of small torch ops: one intra-op
    thread keeps them fast when several test processes share the cores.
    Imported into a test module, it applies to that module's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hierarchical_rank(rank, world, port, D, cap, k, inp, out):
    """One process of a (world, D) run on the CPU over gloo, for
    torch.multiprocessing.spawn: its shards' rows of the block in inp (an
    .npz of codes, qual_ok, lens and the global (S, Q, W) lookup queries
    qw / qv) through HierarchicalCounter, sharded_lookup of its shards'
    queries and the sharded traversal; the results go to out + rank."""
    import json

    import numpy as np

    from mhm2_proxy_tpu_torch.dbjg import traverse_debruijn_graph_sharded
    from mhm2_proxy_tpu_torch.parallel import sharded_lookup
    from mhm2_proxy_tpu_torch.parallel.multihost import HierarchicalCounter, init_multihost

    torch.set_num_threads(1)
    init_multihost(f"localhost:{port}", world, rank, device="cpu")
    z = np.load(inp)
    B = z["codes"].shape[0] // (world * D)
    rows = slice(rank * D * B, (rank + 1) * D * B)
    counter = HierarchicalCounter(k, (world, D), bucket_cap=cap, device="cpu")
    counter.add_reads_block(z["codes"][rows], z["qual_ok"][rows], z["lens"][rows])
    table = counter.finalize()
    mine = slice(rank * D, (rank + 1) * D)
    found = sharded_lookup(table, torch.from_numpy(z["qw"][mine].copy()),
                           torch.from_numpy(z["qv"][mine].copy()))
    stats = {}
    contigs = traverse_debruijn_graph_sharded(table, k, stats=stats)
    np.savez(f"{out}{rank}.npz", words=table.words.numpy(), count=table.count.numpy(),
             left=table.left.numpy(), right=table.right.numpy(), n=table.n.numpy(),
             bound_rows=table.bound_rows, **{f"ans{i}": a.numpy() for i, a in enumerate(found)})
    with open(f"{out}{rank}.json", "w") as f:
        json.dump(dict(contigs=contigs, stitch_rounds=stats["stitch_rounds"],
                       spill_rounds=counter.spill_rounds), f)
    torch.distributed.destroy_process_group()


def traced_rank(rank, world, port, argv, out):
    """One CLI process of a `world`-rank run on the CPU over gloo, for
    torch.multiprocessing.spawn: run_pipeline on argv while a trace records,
    inside one more span, `outside`, which counts whatever the pipeline
    sends outside every span of its own; the `sent_bytes` and `collectives`
    summed by span name go to out + rank (JSON)."""
    import json

    from mhm2_proxy_tpu_torch.main import run_pipeline
    from mhm2_proxy_tpu_torch.options import parse_args
    from mhm2_proxy_tpu_torch.parallel.multihost import init_multihost
    from mhm2_proxy_tpu_torch.utils import trace

    torch.set_num_threads(1)
    os.environ.update(MHM2_TPU_PROC_ID=str(rank), MHM2_TPU_NUM_PROCS=str(world))
    init_multihost(f"localhost:{port}", world, rank, device="cpu")
    with trace.recording(syncs=False) as spans, trace.span("outside"):
        run_pipeline(parse_args(argv))
    rows = {}
    for s in spans:
        row = rows.setdefault(s.name, {"calls": 0})
        row["calls"] += 1
        for c in ("sent_bytes", "alltoall_bytes", "collectives", "records"):
            row[c] = row.get(c, 0) + s.counters.get(c, 0)
    with open(f"{out}{rank}.json", "w") as f:
        json.dump(dict(spans=rows), f)
    torch.distributed.destroy_process_group()
