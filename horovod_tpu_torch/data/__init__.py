"""The port's data path (the counterpart of ``horovod_tpu/data/``): the
loaders (``data_loader``, ``parquet_loader``), the data compute service
(``compute_service``) and its worker main (``compute_worker``)."""

from horovod_tpu_torch.data.data_loader import (  # noqa: F401
    AsyncDataLoaderMixin,
    BaseDataLoader,
    PinnedStager,
    ShardedArrayLoader,
)
