"""Element partitioning, the halo plan and ring exchange, process groups,
and the element-sharded blocked path (see each module)."""
from .blocked_shard import (ShardedBlocked, build_sharded_blocked,
                            initial_send_buffer, join_shards,
                            make_sharded_blocked_step_diff,
                            make_sharded_blocked_step_fused,
                            make_sharded_blocked_step_rdma, split_shards)
from .distributed import distributed_init
from .halo import (HaloPlan, RingExchange, build_halo_plan, halo_tables,
                   ring_exchange)
from .partition import (compute_partition, graph_partition, pad_context,
                        partition_block_sizes, partition_cut, partition_mesh,
                        rcb_block_sizes, rcb_partition, rcm_order)

__all__ = [
    "rcm_order", "rcb_partition", "graph_partition", "partition_cut",
    "compute_partition", "partition_mesh", "partition_block_sizes",
    "rcb_block_sizes", "pad_context",
    "HaloPlan", "build_halo_plan", "halo_tables", "RingExchange",
    "ring_exchange", "distributed_init",
    "ShardedBlocked", "build_sharded_blocked", "initial_send_buffer",
    "make_sharded_blocked_step_fused", "make_sharded_blocked_step_diff",
    "make_sharded_blocked_step_rdma",
    "split_shards", "join_shards",
]
