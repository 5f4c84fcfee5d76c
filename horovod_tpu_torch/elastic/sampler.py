"""ElasticSampler: the port's copy of ``horovod_tpu/elastic/sampler.py``
(ref horovod/torch/elastic/sampler.py:26), with the same partitions, index
for index.

Splits an epoch's indices across ranks; records processed indices at each
commit; on resize, repartitions only the *unprocessed* remainder across the
new world so the epoch continues exactly where it left off (no sample seen
twice, none skipped — the reference's core elastic-data guarantee).

One departure from the JAX sampler (ROADMAP C): ``record_batch`` records
every replica's chunk of the batch, not only this rank's, so every rank
holds the world's progress and a lost rank's progress survives in its
peers' snapshots. That is right for synchronous data-parallel training,
where a rank finishes step b only after every rank reached it (the
gradient allreduce); the partitions are the JAX sampler's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class ElasticSampler:
    def __init__(self, dataset_size: int, shuffle: bool = True,
                 seed: int = 0, rank: Optional[int] = None,
                 num_replicas: Optional[int] = None):
        self.dataset_size = dataset_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed_indices: List[int] = []
        self._explicit_rank = rank
        self._explicit_replicas = num_replicas
        self.reset()

    # -- topology ----------------------------------------------------------
    @property
    def rank(self) -> int:
        if self._explicit_rank is not None:
            return self._explicit_rank
        import horovod_tpu_torch as hvd
        return hvd.rank() if hvd.is_initialized() else 0

    @property
    def num_replicas(self) -> int:
        if self._explicit_replicas is not None:
            return self._explicit_replicas
        import horovod_tpu_torch as hvd
        return hvd.size() if hvd.is_initialized() else 1

    # -- epoch control (ref sampler.py:49 set_epoch, :58 record_batch) ------
    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.processed_indices = []
        self.reset()

    def record_batch(self, batch_idx: int, batch_size: int) -> None:
        """Mark a consumed batch of the world (ref sampler.py:58
        record_batch): every replica's chunk ``batch_idx`` moves to the
        processed set (the partitions are a pure function of the state),
        as the reference's rank-invariant ``processed_num`` counts it."""
        start = batch_idx * batch_size
        n = self.num_replicas
        for r in range(n):
            chunk = self._remaining[r::n][start:start + batch_size]
            self.processed_indices.extend(int(i) for i in chunk)

    def reset(self) -> None:
        """(Re)partition remaining indices over the current world
        (ref sampler.py:66 reset: remaining = all - processed, padded to a
        multiple of num_replicas, strided split)."""
        order = np.arange(self.dataset_size)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        processed = set(self.processed_indices)
        remaining = np.asarray([i for i in order if int(i) not in processed],
                               dtype=np.int64)
        n = self.num_replicas
        # pad so every rank sees the same count (reference wraps around)
        if remaining.size % n != 0 and remaining.size > 0:
            pad = n - remaining.size % n
            remaining = np.concatenate([remaining, remaining[:pad]])
        self._remaining = remaining
        self.num_samples = remaining.size // n if remaining.size else 0
        self.indices = remaining[self.rank::n] if remaining.size else \
            np.asarray([], np.int64)

    def __iter__(self):
        return iter(self.indices.tolist())

    def __len__(self) -> int:
        return int(self.num_samples)

    # -- state -------------------------------------------------------------
    def state_dict(self) -> Dict:
        return {"epoch": self.epoch,
                "processed_indices": list(self.processed_indices)}

    def load_state_dict(self, state: Dict) -> None:
        self.epoch = state["epoch"]
        self.processed_indices = list(state["processed_indices"])
        self.reset()
