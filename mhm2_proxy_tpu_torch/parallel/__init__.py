"""Sharded counting and lookup (port of mhm2_proxy_tpu/parallel on one
process): the flat layout, and the (hosts, devices) layout with the
hierarchical two-stage exchange."""

from .multihost import HierarchicalCounter
from .sharded import ShardedCounter, ShardedTable, all_to_all, sharded_lookup

__all__ = ["HierarchicalCounter", "ShardedCounter", "ShardedTable", "all_to_all",
           "sharded_lookup"]
