"""Sharded counting and lookup (port of mhm2_proxy_tpu/parallel): the flat
layout, the (hosts, devices) layout with the hierarchical two-stage
exchange, and runs over several processes (torch.distributed, comm.py)."""

from .comm import all_to_all
from .multihost import (HierarchicalCounter, check_read_id_disjointness, host_byte_ranges,
                        init_multihost, min_sum_max)
from .sharded import ShardedCounter, ShardedTable, sharded_lookup

__all__ = ["HierarchicalCounter", "ShardedCounter", "ShardedTable", "all_to_all",
           "check_read_id_disjointness", "host_byte_ranges", "init_multihost", "min_sum_max",
           "sharded_lookup"]
