"""Paged-KV serving of the flagship TransformerLM in PyTorch: the engine,
the continuous-batching scheduler and the paged KV cache (the counterparts
of ``horovod_tpu.serving``)."""

from horovod_tpu_torch.serving.engine import ServeEngine, prefill_buckets
from horovod_tpu_torch.serving.kv_cache import (BlockTables, PageAllocator,
                                                PagePool, PrefixIndex)
from horovod_tpu_torch.serving.scheduler import Request, ServeScheduler

__all__ = ["BlockTables", "PageAllocator", "PagePool", "PrefixIndex",
           "Request", "ServeEngine", "ServeScheduler", "prefill_buckets"]
