"""The hierarchical two-stage exchange (port of
mhm2_proxy_tpu/parallel/multihost.py's HierarchicalCounter, on one process).

The reference scales past one node with a node-aware ThreeTierAggrStore
(upcxx-utils/include/upcxx_utils/three_tier_aggr_store.hpp:289-316: rank
microblocks -> node-shared blocks -> one rpc per node pair -> local
fan-out). The S shards are laid out as H hosts of D devices, S = H * D,
host-major (shard = t_host * D + t_dev), all on the run's one device:

  stage A: each shard's records go to the shard of its own host whose
    device index is the target's, t % D (a transpose within each host);
  combine: a presum of each shard's received rows, keyed by the target
    host (the node-shared block dedup: fewer rows cross hosts);
  stage B: each shard's rows go to the same device index of the target
    host, t // D (a transpose across hosts). Its input is at most D * cap
    rows and its buckets hold D * cap, so it cannot overflow.

Stage-A leftovers come back with their global targets for spill rounds.
The target host rides across stage A in the meta word's spare bits. The
output is a ShardedTable of S host-major shards, so the sharded lookup,
traversal and stitch run on it unchanged.
"""

from __future__ import annotations

import torch

from ..ops.u32 import narrow, widen
from .sharded import RecordFns, ShardedCounter, _bucketize, _presum_duplicates

MAX_HOSTS = 256  # the target host rides in 8 spare meta bits


class HierarchicalCounter(ShardedCounter):
    """Sharded k-mer counting with the node-aware two-stage exchange over an
    (n_hosts, per_host) layout of the shards (the reference's
    make_host_mesh shape); supermers on by default, as the reference's."""

    def __init__(self, k: int, layout: tuple[int, int], dmin_thres: int = 2,
                 bucket_cap: int | None = None, device="cuda", use_supermers: bool = True):
        H, D = layout
        if not 1 <= H <= MAX_HOSTS:
            raise ValueError(f"{H} hosts: the target host rides in 8 meta bits (1..{MAX_HOSTS})")
        if D < 1:
            raise ValueError(f"{D} devices a host")
        super().__init__(k, H * D, dmin_thres=dmin_thres, bucket_cap=bucket_cap, device=device,
                         use_supermers=use_supermers)
        self.H, self.D = H, D

    @staticmethod
    def _set_host(payload, t_host, fns: RecordFns):
        """Write each row's target host into its meta word's spare bits."""
        mc, sh = fns.meta_col, fns.host_shift
        meta = widen(payload[..., mc]) & ~(0xFF << sh)
        payload[..., mc] = narrow(meta | (t_host.to(torch.int64) << sh))

    @staticmethod
    def _get_host(rows, fns: RecordFns):
        return ((widen(rows[..., fns.meta_col]) >> fns.host_shift) & 0xFF).to(torch.int32)

    def _route(self, payload, target, valid, cap: int, fns: RecordFns):
        """Stage A, the combine presum and stage B (reference
        multihost.py:137-163); n_sent counts stage A's sends, as the
        reference's."""
        H, D, S, R = self.H, self.D, self.S, fns.R
        self._set_host(payload, target // D, fns)
        bucketsA, overA, (lp, lt_dev, lv) = _bucketize(payload, target % D, valid, D, cap)
        # stage A: slot (h, d_src, d_dst) reaches device d_dst of host h
        rows = bucketsA.view(H, D, D, cap, R).transpose(1, 2).reshape(S, D * cap, R)
        del bucketsA
        rows, th, va, n_comb = _presum_duplicates(
            rows, self._get_host(rows, fns), fns.is_valid(rows.view(-1, R)).view(S, D * cap),
            fns.count_of, fns.with_count, fns.mode)
        # stage B: at most D * cap rows into buckets of D * cap, no leftovers;
        # slot (h_src, d, h_dst) reaches device d of host h_dst
        bucketsB = _bucketize(rows, th, va, H, D * cap)[0]
        del rows, th, va
        recv = bucketsB.view(H, D, H, D * cap, R).permute(2, 1, 0, 3, 4).reshape(S, H * D * cap, R)
        # the leftovers' global targets, rebuilt from the host bits
        g = torch.where(lv, self._get_host(lp, fns) * D + lt_dev, S)
        n_over = int(overA.sum())
        return recv, int(valid.sum()) - n_over, n_over, n_comb, (lp, g, lv)
