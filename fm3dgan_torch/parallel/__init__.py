from fm3dgan_torch.parallel.dist import (
    STATS,
    active,
    all_gather_rows,
    all_reduce_sum,
    any_rank,
    average_gradients,
    barrier,
    broadcast_flag,
    check_replicas_equal,
    init_distributed,
    is_main,
    local,
    local_rows,
    mean_metrics,
    randn_rows,
    rank,
    shutdown,
    world_size,
)

__all__ = ["STATS", "active", "all_gather_rows", "all_reduce_sum", "any_rank", "average_gradients",
           "barrier", "broadcast_flag", "check_replicas_equal", "init_distributed", "is_main",
           "local", "local_rows", "mean_metrics", "randn_rows", "rank", "shutdown", "world_size"]
