"""Traffic kind `ranks`: whole assemblies by several ranks, one process each.

Each job is what `python -m mhm2_proxy_tpu_torch -r <fastq> -o <dir>
--hosts H --shards S` runs in each of the `ranks` processes of one process
group (parallel/multihost.py::init_multihost; NCCL, one card a rank, on a
machine with a card for each): `main.run_pipeline` with the CLI's own
options, every rank reading its own byte range of the interleaved FASTQ and
writing one shared output directory. Rank 0 is this process, on the first
card, so that the harness's memory peak, the program's spans and the
profiled job are rank 0's. Ranks 1 .. are `ranks_worker.py` processes,
started at set-up once the kernels are built, and told each job's options
over their standard input; a job ends when every rank has finished it.

Set-up: the other ranks start and join the group; every rank assembles a
warm-up community (the configuration at `warmup_pairs` pairs), which also
shows that each rank ingested only its own pairs (a program whose ranks
each read the whole FASTQ stops the run here, and one without
`Assembler.read_split` stops before the ranks start); then the community
and its FASTQ.

The check, once the window has closed: the plain reference merges every
pair and assembles the ladder from its own merged reads under the sharded
branch's rules (`reference/sharded.py`), on this card in key blocks; the
other ranks hand over each job's packed reads through their pipes, so that
the merge check covers every pair; each round's `contigs-<k>.fasta` and
the `final_assembly.fasta` are compared with the reference record by
record, cycles by their canonical rotation, ids apart. A job whose ranks'
packed reads and output files hash (sha256) to an earlier job's takes that
job's result; the others are compared in full.

A watchdog stops the run within seconds, with exit code 3 and no result
line, when another rank exits, when a job runs past `job_timeout_s`
(default 240 s), or a step of the set-up that the ranks share (the
rendezvous, the warm-up) past SETUP_TIMEOUT_S.
"""

from __future__ import annotations

import atexit
import contextlib
import hashlib
import json
import math
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ..gen.community import make_community, write_fastq
from ..reference import sharded as ref
from . import ladder

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JOB_TIMEOUT_S = 240
SETUP_TIMEOUT_S = 600


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _argv(ctx, fastq: str, out_dir: str) -> list[str]:
    cfg, p = ctx.config, ctx.workload["params"]
    return ["-r", fastq, "-o", out_dir, "-k", *map(str, cfg["kmer_lens"]),
            "--min-depth-thres", str(cfg["min_depth_thres"]),
            "--min-ctg-print-len", str(cfg["min_ctg_print_len"]),
            "-Q", str(cfg["qual_offset"]), "--device", ctx.device.type,
            "--hosts", str(p["hosts"]), "--shards", str(p["shards"])]


# -- the other ranks and the watchdog --------------------------------------------


def _start_ranks(ctx) -> None:
    st, W = ctx.state, int(ctx.workload["params"]["ranks"])
    port = _free_port()
    st.update(port=port, procs=[], logs=[], deadline=None, stopping=False)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MHM2_TPU_NUM_PROCS=str(W))
    if ctx.device.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    for r in range(1, W):
        log = os.path.join(ctx.tmp, f"rank{r}.log")
        with open(log, "wb") as f:
            st["procs"].append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.traffic.ranks_worker", str(r), str(W),
                 str(port), ctx.device.type],
                cwd=ROOT, env=dict(env, MHM2_TPU_PROC_ID=str(r)), stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=f))
        st["logs"].append(log)
    atexit.register(_kill, list(st["procs"]))
    threading.Thread(target=_watch, args=(ctx,), daemon=True).start()


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()


def _watch(ctx) -> None:
    st = ctx.state
    while not st["stopping"]:
        _check_ranks(ctx)
        step = st["deadline"]
        if step is not None and time.monotonic() - step[0] > step[1] and not st["stopping"]:
            _abort(ctx, f"a step of the ranks ran past {step[1]:.0f} s")
        time.sleep(0.5)


def _check_ranks(ctx) -> None:
    for r, p in enumerate(ctx.state["procs"], 1):
        if p.poll() is not None and not ctx.state["stopping"]:
            _abort(ctx, f"rank {r} exited with code {p.returncode}")


def _abort(ctx, why: str) -> None:
    """Stop the run: no result line, a non-zero exit, every rank killed."""
    st = ctx.state
    _log(f"ranks: {why}; stopping the run")
    for r, log in enumerate(st["logs"], 1):
        with contextlib.suppress(OSError):
            with open(log, "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
            _log(f"--- rank {r} (last lines of its log)\n{tail}")
    _kill(st["procs"])
    os._exit(3)


@contextlib.contextmanager
def _timed_step(ctx, limit_s: float):
    """A step that every rank takes: the watchdog stops the run when it
    runs past limit_s, and so does its failure when a rank has exited."""
    ctx.state["deadline"] = (time.monotonic(), limit_s)
    try:
        yield
    except Exception:
        time.sleep(1.0)  # a rank that died takes the group's collectives with it
        _check_ranks(ctx)
        raise
    finally:
        ctx.state["deadline"] = None


def _send(ctx, msg: dict) -> None:
    line = (json.dumps(msg) + "\n").encode()
    for p in ctx.state["procs"]:
        p.stdin.write(line)
        p.stdin.flush()


def _reply(p) -> dict:
    line = p.stdout.readline()
    if not line:
        raise RuntimeError("a rank closed its pipe")
    return json.loads(line)


def _stop_ranks(ctx) -> None:
    st = ctx.state
    if not st.get("procs") or st["stopping"]:
        return
    st["stopping"] = True
    with contextlib.suppress(OSError):
        _send(ctx, {"cmd": "stop"})
    for p in st["procs"]:
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
    import torch.distributed as dist

    # gloo's group goes here (the tests run rank 0 in their own process); an
    # NCCL group's teardown waits for its peers, which have left: it goes
    # with this process
    if dist.is_initialized() and dist.get_backend() == "gloo":
        dist.destroy_process_group()


# -- set-up and jobs -----------------------------------------------------------------


def setup(ctx) -> None:
    from mhm2_proxy_tpu_torch.models.assembler import Assembler
    from mhm2_proxy_tpu_torch.parallel.multihost import init_multihost

    if not hasattr(Assembler, "read_split"):
        # a program without per-rank ingest: its ranks would each read the
        # whole FASTQ, which the warm-up below would find after a minute
        raise RuntimeError("the program has no per-rank ingest (Assembler.read_split): "
                           "each rank has to read only its own byte range of the FASTQ")
    cfg, p = ctx.config, ctx.workload["params"]
    parts = ctx.state["setup_parts"] = {}
    t0 = time.perf_counter()
    _start_ranks(ctx)
    warm_cfg = dict(cfg, pairs=min(cfg["pairs"], int(p["warmup_pairs"])))
    warm_com = make_community(warm_cfg, ctx.seed)
    warm = os.path.join(ctx.tmp, "warmup.fastq")
    write_fastq(warm_com, warm, cfg["qual_offset"])
    t1 = time.perf_counter()
    with _timed_step(ctx, SETUP_TIMEOUT_S):
        init_multihost(f"localhost:{ctx.state['port']}", int(p["ranks"]), 0,
                       device=ctx.device.type)
    t2 = time.perf_counter()
    with _timed_step(ctx, SETUP_TIMEOUT_S):
        got = _run_job(ctx, warm, os.path.join(ctx.tmp, "warmup"), "warmup")
    pairs = [r["pairs"] for r in got["ranks"]]
    if sum(pairs) != warm_com.n_pairs:
        raise RuntimeError(
            f"the ranks ingested {pairs} pairs of the warm-up's {warm_com.n_pairs}: each rank "
            "has to read only its own byte range of the FASTQ")
    os.remove(warm)
    t3 = time.perf_counter()
    com = ctx.state["community"] = make_community(cfg, ctx.seed)
    t4 = time.perf_counter()
    fq = ctx.state["fastq"] = os.path.join(ctx.tmp, "reads.fastq")
    write_fastq(com, fq, cfg["qual_offset"])
    parts.update(ranks_and_warmup_community=t1 - t0, join=t2 - t1, warmup=t3 - t2,
                 community=t4 - t3, fastq=time.perf_counter() - t4)


READ_BLOCK = 1 << 17


def pairs_of(packed) -> int:
    """The pairs of a rank's packed reads: its distinct pair ids
    ((|read id| - 1) // 2)."""
    ids = np.concatenate([b[3] for b in packed.blocks(READ_BLOCK, with_ids=True)])
    return int(np.unique((np.abs(ids[ids != 0]) - 1) // 2).size)


def _run_job(ctx, fastq: str, out: str, name) -> dict:
    """One assembly by every rank: this rank's run_pipeline, then each
    other rank's report of the same job."""
    from mhm2_proxy_tpu_torch.main import run_pipeline
    from mhm2_proxy_tpu_torch.options import parse_args

    argv = _argv(ctx, fastq, out)
    recording = _is_recording()
    _send(ctx, {"cmd": "job", "job": name, "argv": argv, "trace": recording,
                "keep": isinstance(name, int)})
    with recording_spans(recording) as spans:
        asm = run_pipeline(parse_args(argv))
    mine = dict(rank=0, peak_bytes=max((r["peak_bytes"] for r in asm.round_stats.values()),
                                       default=0),
                spans=span_summary(spans, "ingest.parse", "count.exchange",
                                    "traverse.exchange") if recording else {})
    mine["pairs"] = pairs_of(asm.packed_reads)
    ranks = [mine] + [_reply(p) for p in ctx.state["procs"]]
    for r in ranks:
        parse = r["spans"].get("ingest.parse", {})
        _log(f"job {name} rank {r['rank']}: {r['pairs']} pairs, peak {r['peak_bytes']} bytes"
             + (f", ingest.parse {parse.get('bytes', 0)} bytes" if parse else ""))
    return dict(asm=asm, ranks=ranks)


def _is_recording() -> bool:
    try:
        from mhm2_proxy_tpu_torch.utils import trace
    except ImportError:
        return False
    return trace.is_recording()


@contextlib.contextmanager
def recording_spans(on: bool):
    """The spans that close in the block, while an outer recording is open
    (it records once); None otherwise."""
    if not on:
        yield None
        return
    from mhm2_proxy_tpu_torch.utils import trace

    with trace.recording(syncs=False) as spans:
        n0 = len(spans)
        box = []
        yield box
        box.extend(spans[n0:])


def span_summary(spans, *names) -> dict:
    out: dict = {}
    for s in spans or ():
        if s.name in names:
            row = out.setdefault(s.name, {"seconds": 0.0})
            row["seconds"] += (s.t1 - s.t0) / 1e9
            for c, v in s.counters.items():
                row[c] = row.get(c, 0) + v
    return out


def span_targets():
    """(owner, attribute, span name) of the layers a traced job is cut into."""
    from mhm2_proxy_tpu_torch.models import assembler
    from mhm2_proxy_tpu_torch.parallel import multihost, sharded

    return [
        (assembler.Assembler, "load_reads", "ingest"),
        (assembler.Assembler, "run_round", "round"),
        (multihost.HierarchicalCounter, "add_reads_block", "count.reads"),
        (assembler.Assembler, "_add_ctg_kmers", "count.contigs"),
        (sharded.ShardedCounter, "finalize", "count.finalize"),
        (assembler, "traverse_debruijn_graph_sharded", "traverse"),
        (assembler, "write_fasta", "write_fasta"),
    ]


def job(ctx, i: int) -> dict:
    out = os.path.join(ctx.tmp, f"job{i}")
    with _timed_step(ctx, float(ctx.workload["params"].get("job_timeout_s", JOB_TIMEOUT_S))):
        got = _run_job(ctx, ctx.state["fastq"], out, i)
    asm = got["asm"]
    with open(os.path.join(out, "mhm2_torch.log")) as f:
        log = f.read().splitlines()
    return dict(out_dir=out, log=log, round_stats=dict(asm.round_stats),
                packed_reads=asm.packed_reads, ranks=got["ranks"])


def end_to_end(ctx, jobs, wall_s: float) -> dict:
    return {"assembly_s": wall_s / len(jobs)}


# -- the check -----------------------------------------------------------------------


def _ask(ctx, r: int, msg: dict):
    """Send rank r (1 ..) one command; its pipe, for the answer."""
    p = ctx.state["procs"][r - 1]
    p.stdin.write((json.dumps(msg) + "\n").encode())
    p.stdin.flush()
    return p


def reads_digest(packed) -> str:
    """sha256 of a rank's packed reads: codes, quals, lengths and ids."""
    h = hashlib.sha256()
    for blk in packed.blocks(READ_BLOCK, with_ids=True):
        for a in blk:
            h.update(a.tobytes())
    return h.hexdigest()


def _job_digest(ctx, jb: dict, i: int, files: list[str]) -> tuple:
    """Every rank's digest of job i's packed reads and the digests of its
    output files: jobs with one digest have one check result."""
    rks = [rk["rank"] for rk in jb["ranks"]]
    pipes = {r: _ask(ctx, r, {"cmd": "digest", "job": i}) for r in rks if r}
    reads = [reads_digest(jb["packed_reads"]) if r == 0 else _reply(pipes[r])["digest"]
             for r in rks]
    out = []
    for f in files:
        with open(f, "rb") as fh:
            out.append(hashlib.sha256(fh.read()).hexdigest())
    return tuple(reads), tuple(out)


def _rank_blocks(ctx, i: int, r: int):
    """Rank r's packed-read blocks of job i, (codes, quals, lens, ids), over its pipe."""
    p = _ask(ctx, r, {"cmd": "reads", "job": i})
    head = _reply(p)
    blocks = []
    for shapes in head["blocks"]:
        arrs = []
        for dtype, shape in shapes:
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            buf = p.stdout.read(n)
            if len(buf) != n:
                raise RuntimeError(f"rank {r} sent {len(buf)} of {n} bytes")
            arrs.append(np.frombuffer(buf, dtype).reshape(shape))
        blocks.append(tuple(arrs))
    return blocks


def _all_reads(ctx, jb: dict, i: int):
    """Every rank's packed reads of a job as one PackedReads, each read's
    pair id moved from its rank's own numbering (the rank's id base on) to
    its pair's place in the FASTQ (the pairs of the ranks before it on)."""
    from mhm2_proxy_tpu_torch.io.reads import PackedReads
    from mhm2_proxy_tpu_torch.models.assembler import Assembler

    out = PackedReads(ctx.config["qual_offset"])
    first = 0
    for rk in jb["ranks"]:
        r = rk["rank"]
        blocks = (jb["packed_reads"].blocks(READ_BLOCK, with_ids=True) if r == 0
                  else _rank_blocks(ctx, i, r))
        base = r * Assembler.READ_ID_STRIDE // 2
        for codes, quals, lens, ids in blocks:
            pid = (np.abs(ids) - 1) // 2 - base + first
            new = np.where(ids < 0, -(2 * pid + 1), 2 * pid + 1)
            out.add_block(codes, quals, lens, ids=np.where(ids == 0, 0, new))
        first += rk["pairs"]
    return out


def _round_faults(got, want, k: int) -> int:
    """Records of one round file that differ from the reference's (cycles
    by their canonical rotation), and the file's records out of place."""
    return (ladder.records_diff(ref.rotated(got, k), ref.rotated(want, k))
            + ref.id_faults(got))


def check(ctx, jobs, depth_dtype=None):
    """({name: (value, limit)} of every compared number, the jobs with any
    difference). depth_dtype "float32" is the control: the reference's
    depths divided in float32."""
    try:
        return _check(ctx, jobs, depth_dtype)
    finally:
        _stop_ranks(ctx)


def _check(ctx, jobs, depth_dtype):
    com, cfg = ctx.state["community"], ctx.config
    ks, kmax = cfg["kmer_lens"], cfg["kmer_lens"][-1]
    t0 = time.perf_counter()
    ref_merge, reads = ladder.reference_reads(ctx, ctx.device)
    _log(f"reference merge: {int(ref_merge[0].sum())} of {com.n_pairs} pairs merged in "
         f"{time.perf_counter() - t0:.2f}s")
    parts = ctx.workload["params"].get("check_parts")
    rounds = ref.assemble(reads, ks, cfg["min_depth_thres"],
                          n_parts=lambda k: parts or key_blocks(reads, k, ctx.device),
                          depth_dtype=depth_dtype, log=_log)
    del reads
    want = {k: ref.expected_records(rounds[k]) for k in ks}
    want_final = [r for r in want[kmax] if len(r[2]) >= cfg["min_ctg_print_len"]]
    n_cyc_ref = sum(ref.is_cycle(s, k) for k in ks for _, _, s in want[k])
    merge_bad = contig_bad = final_bad = failed = n_cyc = 0
    # a job whose reads and files equal an earlier job's, digest for digest,
    # has that job's result: the program assembles one FASTQ every job
    seen = {}
    for i, jb in enumerate(jobs):
        key = _job_digest(ctx, jb, i, [os.path.join(jb["out_dir"], f"contigs-{k}.fasta")
                                       for k in ks]
                          + [os.path.join(jb["out_dir"], "final_assembly.fasta")])
        if key not in seen:
            seen[key] = _job_faults(ctx, jb, i, ref_merge, want, want_final)
        else:
            for rk in jb["ranks"][1:]:
                _ask(ctx, rk["rank"], {"cmd": "drop", "job": i})
        m, c, f, cyc = seen[key]
        merge_bad, contig_bad, final_bad = merge_bad + m, contig_bad + c, final_bad + f
        n_cyc += cyc
        failed += bool(m or c or f)
    _log(f"cyclic contigs over the rounds: program {n_cyc} in {len(jobs)} jobs, reference "
         f"{n_cyc_ref} a job; {len(seen)} distinct jobs checked")
    checks = {
        "merge_pairs_differing": (merge_bad, 0),
        "round_contigs_differing": (contig_bad, 0),
        "final_contigs_differing": (final_bad, 0),
        "cyclic_contigs": (n_cyc, n_cyc_ref * len(jobs)),
    }
    return checks, failed


def _job_faults(ctx, jb: dict, i: int, ref_merge, want: dict, want_final):
    """(pairs whose merge differs, round records and final records that
    differ, the cyclic contigs of the rounds) of job i."""
    com, cfg = ctx.state["community"], ctx.config
    ks, kmax = cfg["kmer_lens"], cfg["kmer_lens"][-1]
    packed = _all_reads(ctx, jb, i)
    prog = ladder._program_pairs(packed, com.n_pairs, com.codes1.shape[1], cfg["qual_offset"])
    del packed
    m = ladder._merge_diff(prog, ref_merge, com)
    del prog
    c = n_cyc = 0
    for k in ks:
        got = ref.parse_records(ladder.fasta_records(
            os.path.join(jb["out_dir"], f"contigs-{k}.fasta")))
        c += _round_faults(got, want[k], k)
        n_cyc += sum(ref.is_cycle(s, k) for _, _, s in got)
        if k == kmax:
            round_long = [r for r in got if len(r[2]) >= cfg["min_ctg_print_len"]]
    final = ref.parse_records(ladder.fasta_records(
        os.path.join(jb["out_dir"], "final_assembly.fasta")))
    # the final file: the last round's long records, ids and all
    f = (ladder.records_diff(ref.rotated(final, kmax), ref.rotated(want_final, kmax))
         + ladder.records_diff([f"{r}" for r in final], [f"{r}" for r in round_long]))
    return m, c, f, n_cyc


def key_blocks(reads, k: int, device) -> int:
    """Key blocks enough that one block's occurrences of round k, with
    their sort (~16 W + 64 bytes each, W words a k-mer), take at most half
    of the card's free memory (one block on the CPU)."""
    if device.type != "cuda":
        return 1
    free = torch.cuda.mem_get_info(device)[0]
    positions = int(reads[0].shape[0])
    return max(1, math.ceil(positions * (16 * ref.n_words(k) + 64) / (free / 2)))

