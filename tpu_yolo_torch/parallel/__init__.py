from tpu_yolo_torch.parallel.mesh import (
    DataParallel,
    Mesh,
    all_reduce_flat_,
    all_reduce_sum,
    as_data_parallel,
    barrier,
    broadcast_,
    close_distributed,
    gather_objects,
    init_distributed,
    is_distributed,
    make_mesh,
    rank,
    world_size,
)

__all__ = ["DataParallel", "Mesh", "make_mesh", "init_distributed",
           "close_distributed", "is_distributed", "world_size", "rank",
           "all_reduce_sum", "all_reduce_flat_", "broadcast_",
           "gather_objects", "barrier", "as_data_parallel"]
