"""Elastic control-flow exceptions: the port's copy of
``horovod_tpu/elastic/exceptions.py`` (ref horovod/common/exceptions.py:
HorovodInternalError :20, HostsUpdatedInterrupt :26)."""


class HorovodInternalError(RuntimeError):
    """A collective failed mid-step (chip/host loss). The elastic run wrapper
    catches this, restores committed state, and re-initializes."""


class HostsUpdatedInterrupt(Exception):
    """The driver discovered a topology change; raised at the next commit()
    boundary so training re-rendezvouses without losing progress.
    ``skip_sync=True`` when only *new* hosts appeared (state is intact, no
    restore needed — ref common/elastic.py HostsUpdatedInterrupt usage)."""

    def __init__(self, skip_sync: bool = False):
        super().__init__()
        self.skip_sync = skip_sync


class WorkersAvailableException(Exception):
    """Internal driver signal: enough workers to (re)start."""


class ResizeInterrupt(HorovodInternalError):
    """The world is being live-resized / elastically reset
    (elastic/resize.py, ``eager.reset_outstanding``): this outstanding
    eager handle was resolved instead of being waited on over a process
    group that is about to be destroyed. The owning step must be replayed
    after the resize commits — the tensor was never reduced. Raised
    from ``Handle.wait()``/``synchronize()`` of any collective enqueued
    before the reset ran. Subclasses :class:`HorovodInternalError` so a
    wait that escapes into the ``hvd.elastic.run`` retry loop triggers
    the normal restore-and-retry instead of crashing the wrapper."""

    def __init__(self, reason: str = ""):
        super().__init__(reason)
        self.reason = reason


class PreemptionInterrupt(Exception):
    """The process-global PreemptionHandler (resilience/preemption.py)
    was armed — this host is being maintenance-evicted. Raised at the
    next ``State.commit()`` boundary (state just persisted) so the
    elastic worker can exit with the RESUMABLE status instead of being
    SIGKILLed mid-step; the launcher re-forms the world without
    blacklisting the host."""

    def __init__(self, reason: str = ""):
        super().__init__(reason)
        self.reason = reason
