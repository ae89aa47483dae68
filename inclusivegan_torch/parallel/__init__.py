"""Data parallelism over ``torch.distributed`` (``dist.py``)."""

from .dist import (active, all_reduce_mean, all_reduce_mean_, barrier, broadcast_,
                   broadcast_object, check_devices, gather_to_main, init_data_parallel,
                   is_main, rank, replicas_identical, world_size)

__all__ = ["active", "all_reduce_mean", "all_reduce_mean_", "barrier", "broadcast_",
           "broadcast_object", "check_devices", "gather_to_main", "init_data_parallel",
           "is_main", "rank", "replicas_identical", "world_size"]
