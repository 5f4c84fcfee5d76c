from horovod_tpu_torch.runtime.context import (NotInitializedError,
                                               cross_rank, cross_size,
                                               get_context, init,
                                               is_homogeneous,
                                               is_initialized, local_rank,
                                               local_size, mesh, rank,
                                               shutdown, size)

__all__ = ["NotInitializedError", "cross_rank", "cross_size", "get_context",
           "init", "is_homogeneous", "is_initialized", "local_rank",
           "local_size", "mesh", "rank", "shutdown", "size"]
