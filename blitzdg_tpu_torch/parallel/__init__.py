"""Element partitioning, the halo plan and exchanges, the element-sharded
plain-tensor path, sharded contexts and meshes, process groups, the
element-sharded blocked path and its transport across ranks (see each
module)."""
from .blocked_shard import (ShardedBlocked, build_sharded_blocked,
                            initial_send_buffer, join_shards,
                            make_sharded_blocked_step_diff,
                            make_sharded_blocked_step_fused,
                            make_sharded_blocked_step_rdma, split_shards,
                            sum_over_ranks_grad, total_over_ranks)
from .distributed import distributed_init, make_global_mesh
from .halo import (HaloPlan, RingExchange, build_gauss_halo_plan,
                   build_halo_plan, halo_comm_model, halo_face_rows,
                   halo_poisson2d_op, halo_sw2d_curved_rhs, halo_sw2d_rhs,
                   halo_sw2d_timestep, halo_tables, halo_traces,
                   ring_exchange, sum_over_ranks)
from .peer import (HaloRing, PeerRing, StageRing, halo_slot_bytes,
                   peer_halo_exchange, peer_halo_exchange_reverse,
                   peer_rank_max, peer_rank_sum, peer_ring_exchange,
                   peer_stage_exchange, peer_stage_exchange_reverse,
                   rank_order_max, rank_order_sum)
from .partition import (compute_partition, graph_partition, pad_context,
                        pad_elements, partition_block_sizes, partition_cut,
                        partition_mesh, rcb_block_sizes, rcb_partition,
                        rcm_order)
from .sharding import (CUBATURE_SHARDED_FIELDS, ELEMENT_SHARDED_FIELDS,
                       GAUSS_SHARDED_FIELDS, StackedMesh,
                       context_shard_specs, cubature_shard_specs,
                       gauss_shard_specs, make_device_mesh, shard_context)

__all__ = [
    "rcm_order", "rcb_partition", "graph_partition", "partition_cut",
    "compute_partition", "partition_mesh", "partition_block_sizes",
    "rcb_block_sizes", "pad_context", "pad_elements",
    "ELEMENT_SHARDED_FIELDS", "CUBATURE_SHARDED_FIELDS",
    "GAUSS_SHARDED_FIELDS", "StackedMesh", "make_device_mesh",
    "shard_context", "context_shard_specs", "cubature_shard_specs",
    "gauss_shard_specs",
    "distributed_init", "make_global_mesh",
    "HaloPlan", "build_halo_plan", "build_gauss_halo_plan", "halo_tables",
    "halo_comm_model", "halo_face_rows", "halo_traces", "halo_sw2d_rhs",
    "halo_poisson2d_op", "halo_sw2d_timestep", "halo_sw2d_curved_rhs",
    "RingExchange", "ring_exchange", "sum_over_ranks",
    "ShardedBlocked", "build_sharded_blocked", "initial_send_buffer",
    "make_sharded_blocked_step_fused", "make_sharded_blocked_step_diff",
    "make_sharded_blocked_step_rdma", "PeerRing", "peer_ring_exchange",
    "StageRing", "peer_stage_exchange", "peer_stage_exchange_reverse",
    "peer_rank_sum", "rank_order_sum", "HaloRing", "halo_slot_bytes",
    "peer_halo_exchange", "peer_halo_exchange_reverse", "peer_rank_max",
    "rank_order_max", "sum_over_ranks_grad",
    "total_over_ranks", "split_shards", "join_shards",
]
