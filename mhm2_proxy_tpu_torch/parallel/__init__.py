"""Sharded counting and lookup (port of mhm2_proxy_tpu/parallel, the flat
single-process layout)."""

from .sharded import ShardedCounter, ShardedTable, all_to_all, sharded_lookup

__all__ = ["ShardedCounter", "ShardedTable", "all_to_all", "sharded_lookup"]
