"""Cluster integrations of the port (the counterpart of
``horovod_tpu/integrations/``; reference L8: horovod/ray/, horovod/spark/).

- ``executor.TpuExecutor``: persistent worker-pool executor, one rank a
  card (the actor substrate; ref ray/runner.py:168 RayExecutor's worker
  model).
- ``ray_executor.RayExecutor``: API-parity Ray executor (real Ray actors
  when ray is installed and initialized, the local pool otherwise).
- ``spark.run`` / ``spark.run_elastic``: horovod.spark.run analogue
  (pyspark barrier stage when installed).
- ``estimator.TpuEstimator``: Estimator/Model fit/predict API
  (ref spark/common/estimator.py:25) over ``nn.Module`` models and
  ``torch.optim`` optimizers, with per-epoch + best-model checkpointing
  into a ``store.Store``; ``fit_on_parquet`` streams a Parquet dataset
  from shared storage inside the workers.
- ``store.Store`` / ``FilesystemStore`` / ``FsspecStore``: artifact store
  for checkpoints, logs, and fitted models over local paths or remote
  URLs (ref spark/common/store.py LocalStore/HDFSStore/S3Store).
"""

from horovod_tpu_torch.integrations.executor import TpuExecutor  # noqa: F401
from horovod_tpu_torch.integrations.estimator import (  # noqa: F401
    TpuEstimator, TpuModel)
from horovod_tpu_torch.integrations.store import (  # noqa: F401
    FilesystemStore, FsspecStore, LocalStore, Store)
