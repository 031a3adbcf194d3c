"""One rank (1 ..) of the `ranks` traffic kind, in a process of its own.

    python -m benchmark.traffic.ranks_worker RANK WORLD PORT DEVICE

Joins the run's process group (rank 0, the harness, holds it at
tcp://localhost:PORT) on `cuda:<RANK>` with NCCL, or on the CPU with gloo,
then takes one JSON command a line on standard input:

- {"cmd": "job", "job": i, "argv": [...], "trace": bool}: the program's
  `main.run_pipeline` on the CLI options argv, while a trace records when
  `trace` is set (as rank 0's does); keeps the job's packed reads when
  `keep` is set, and answers one JSON line: its pairs, its peak device memory and, traced,
  its exchange and ingest spans;
- {"cmd": "digest", "job": i}: a JSON line with the sha256 of the job's
  packed reads (`ranks.reads_digest`);
- {"cmd": "reads", "job": i}: the job's packed reads: a JSON line of the
  blocks' array shapes, then the arrays' bytes (codes, quals, lens, ids of
  each block), and forgets them;
- {"cmd": "drop", "job": i}: forgets the job's packed reads, with no answer;
- {"cmd": "stop"}: exits, leaving the group as it goes.

Standard output carries only these answers: whatever else would print
goes to standard error, which the harness keeps in a log of the rank.
"""

from __future__ import annotations

import json
import os
import sys


def main(argv=None) -> int:
    rank, world, port, device = (sys.argv[1:] if argv is None else argv)[:4]
    rank, world = int(rank), int(world)
    answers = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    import torch

    from benchmark.traffic.ranks import (READ_BLOCK, pairs_of, reads_digest, recording_spans,
                                         span_summary)
    from mhm2_proxy_tpu_torch.main import run_pipeline
    from mhm2_proxy_tpu_torch.options import parse_args
    from mhm2_proxy_tpu_torch.parallel.multihost import init_multihost

    if device == "cpu":
        torch.set_num_threads(1)
    init_multihost(f"localhost:{port}", world, rank, device=device)

    def answer(msg: dict, arrays=()):
        answers.write((json.dumps(msg) + "\n").encode())
        for a in arrays:
            answers.write(memoryview(a).cast("B"))
        answers.flush()

    kept = {}
    for line in sys.stdin:
        msg = json.loads(line)
        if msg["cmd"] == "job":
            with recording_spans(msg["trace"]) as spans:
                asm = run_pipeline(parse_args(msg["argv"]))
            if msg["keep"]:
                kept[str(msg["job"])] = asm.packed_reads
            peak = max((r["peak_bytes"] for r in asm.round_stats.values()), default=0)
            answer(dict(rank=rank, pairs=pairs_of(asm.packed_reads), peak_bytes=peak,
                        spans=span_summary(spans, "ingest.parse", "count.exchange",
                                            "traverse.exchange") if msg["trace"] else {}))
            del asm
        elif msg["cmd"] == "digest":
            answer({"digest": reads_digest(kept[str(msg["job"])])})
        elif msg["cmd"] == "drop":
            del kept[str(msg["job"])]
        elif msg["cmd"] == "reads":
            packed = kept.pop(str(msg["job"]))
            blocks = [tuple(a for a in b) for b in packed.blocks(READ_BLOCK, with_ids=True)]
            answer({"blocks": [[[a.dtype.str, list(a.shape)] for a in b] for b in blocks]},
                   [a for b in blocks for a in b])
        elif msg["cmd"] == "stop":
            break
    answers.close()
    sys.stderr.flush()
    # the group's teardown would wait for the other ranks' (NCCL's is
    # collective): the process leaves it as it exits
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
