"""Checkpoint/resume helpers of the port.

The counterpart of ``horovod_tpu/checkpoint.py``:

- ``save_checkpoint`` / ``restore_checkpoint``: one training state to one
  path, written through the crash-safe commit of
  ``resilience/async_checkpoint`` (a tmp dir, the manifest, one atomic
  rename) instead of orbax, which the port does not have. Each rank
  writes its own shard; restore writes into a live ``template`` (tensors
  by ``copy_``, modules and optimizers by ``load_state_dict``).
- ``CheckpointManager``: newest-k rotation + resume-latest on top
  (``max_to_keep``), the train-loop-facing surface.

Not ported yet: ``CheckpointManager.compat_report`` (the serving handoff
gate of the JAX package's analysis subsystem).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional


def _normalize(path: str) -> str:
    """Absolute for local filesystem paths; URIs pass through untouched
    (the port writes local paths only; a URI raises at the write)."""
    return path if "://" in path else os.path.abspath(path)


def save_checkpoint(path: str, state: Any, force: bool = False) -> None:
    """Write ``state`` to ``path``. Every rank calls it (each writes its
    own shard, rank 0 the replicated leaves and the commit). An existing
    checkpoint at ``path`` is an error unless ``force=True`` (which
    DELETES it)."""
    from horovod_tpu_torch.resilience.async_checkpoint import (
        AsyncCheckpointer, step_dirname)
    from horovod_tpu_torch.utils import schedhooks
    rank, world = schedhooks.process_world()

    def barrier():
        if world > 1:
            import torch.distributed as dist
            dist.barrier()

    path = _normalize(path)
    exists = os.path.exists(path)
    barrier()
    if exists and not force:
        raise ValueError(f"checkpoint path {path} already exists; "
                         f"pass force=True to overwrite it")
    parent, name = os.path.split(path)
    stage = os.path.join(parent, f".stage-{name}")
    if rank == 0:
        shutil.rmtree(path, ignore_errors=True)
        shutil.rmtree(stage, ignore_errors=True)
    barrier()
    with AsyncCheckpointer(stage, interval=0, max_to_keep=0) as ck:
        ck.save(0, state, sync=True)
    barrier()
    if rank == 0:
        os.rename(os.path.join(stage, step_dirname(0)), path)
        shutil.rmtree(stage, ignore_errors=True)
    barrier()


def restore_checkpoint(path: str, template: Optional[Any] = None) -> Any:
    """Restore a checkpoint written by :func:`save_checkpoint`. With
    ``template`` (the live state), the values are written into it and its
    structure is returned; without, the host tree (CPU tensors, numpy
    arrays, ``state_dict``s) is."""
    from horovod_tpu_torch.resilience.async_checkpoint import (
        _load, read_manifest)
    path = _normalize(path)
    manifest = read_manifest(path)
    if manifest is None:
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    return _load(path, manifest, template)


class CheckpointManager:
    """Step-indexed checkpoint rotation for train loops (the
    rank-0-saves-every-N-epochs pattern of the reference's examples as a
    managed object).

    ``save(step, state)`` keeps the newest ``max_to_keep`` checkpoints;
    ``latest_step()``/``restore(step=None, template=...)`` resume.

    Backed by the resilience subsystem's crash-safe commit protocol
    (resilience/async_checkpoint): each save lands in a tmp dir, its
    manifest is written, and ONE atomic rename publishes it; older
    checkpoints are deleted only after the new manifest is committed, so
    a crash at any point leaves the previous newest snapshot intact and
    ``restore()``/``latest_step()`` skip partial/uncommitted directories
    instead of erroring. Saves are async (a background writer thread);
    every reader synchronizes first."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        from horovod_tpu_torch.resilience.async_checkpoint import (
            AsyncCheckpointer)
        self.directory = _normalize(directory)
        # interval=0: cadence is the caller's business here — every
        # explicit save() runs; maybe_save gating is AsyncCheckpointer's.
        self._ckpt = AsyncCheckpointer(self.directory, interval=0,
                                       max_to_keep=max_to_keep)

    def save(self, step: int, state: Any, wait: bool = False) -> None:
        """Async by default: serialization + commit overlap subsequent
        training steps on the writer thread; readers below synchronize
        first. wait=True blocks until the write is durably committed."""
        self._ckpt.save(step, state, sync=wait)

    def latest_step(self) -> Optional[int]:
        return self._ckpt.latest_step()

    def all_steps(self) -> List[int]:
        return self._ckpt.all_steps()

    def restore(self, step: Optional[int] = None,
                template: Optional[Any] = None) -> Any:
        try:
            return self._ckpt.restore(step=step, template=template)
        except FileNotFoundError:
            if step is not None:
                raise                      # precise per-step message
            self._raise_if_legacy_layout()
            raise FileNotFoundError(
                f"no checkpoints in {self.directory}") from None

    def _raise_if_legacy_layout(self) -> None:
        """The manifest-committed layout replaced the orbax
        CheckpointManager layout (bare integer step dirs) in the JAX
        package. Such a directory must not silently read as 'no
        checkpoints': name what it holds."""
        try:
            legacy = sorted(int(n) for n in os.listdir(self.directory)
                            if n.isdigit())
        except OSError:
            return
        if legacy:
            raise FileNotFoundError(
                f"{self.directory} holds checkpoints in the legacy orbax "
                f"CheckpointManager layout (steps {legacy}), which only "
                f"the JAX package reads (restore_checkpoint('"
                f"{self.directory}/{legacy[-1]}/default', template=...)); "
                f"resave them through this manager to adopt the "
                f"committed layout")

    def close(self) -> None:
        self._ckpt.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
