"""Fleet router: occupancy- and prefix-affinity-aware request placement
across serving replicas, the counterpart of
``horovod_tpu/serving/router.py``.

Placement policy, evaluated per request at dispatch time over the
replicas currently admitting (READY, never DRAINING or DEAD):

1. **Prefix affinity.** With the prefix cache on, a replica whose
   hash-chain index already holds pages of this prompt's prefix is worth
   routing to: the admission there adopts the resident pages and skips
   their prefill, and shared pages only pay off when requests with a
   common prefix land on the SAME replica. The score is the number of
   prompt tokens the replica's index covers (``PrefixIndex.match``'s skip
   plus the copy-on-write tail); the best strictly positive score wins,
   load breaking exact ties.
2. **Least load.** Otherwise (no resident prefix anywhere, or caching
   off): the replica with the fewest requests aboard (queued +
   prefilling + decoding), join-shortest-queue over the occupancy the
   scheduler already tracks.

Ties break on the registry's stable member order (existing replicas
first), so placement is deterministic: the same arrival sequence against
the same fleet state routes identically, which is what makes the
fleet-of-one bitwise contract and the re-admission order meaningful.

The dispatch path is the chaos injection point of the replica drills:
``replica_kill`` fires here (the chosen replica dies BEFORE the request
lands; the router reconciles through the fleet and re-routes), and
``replica_slow`` adds its delay here.
"""

from __future__ import annotations

import time
from typing import TYPE_CHECKING, List

import numpy as np

from horovod_tpu_torch.resilience import chaos
from horovod_tpu_torch.serving.scheduler import Request

if TYPE_CHECKING:                                     # pragma: no cover
    from horovod_tpu_torch.serving.fleet import EngineReplica, ServingFleet


class FleetUnavailable(RuntimeError):
    """No replica is admitting (all draining or dead and the autoscaler
    floor is 0): the caller's request cannot be placed."""


class FleetRouter:
    """Stateless-per-request placement over a :class:`ServingFleet`'s
    admitting replicas; all fleet mutation (kill reconcile, metrics)
    stays in the fleet: the router only chooses and dispatches."""

    def __init__(self, fleet: "ServingFleet", affinity: bool = True):
        self.fleet = fleet
        self.affinity = bool(affinity)
        self.dispatches = 0
        self.affinity_hits = 0
        self.slow_injected_s = 0.0

    # -- scoring -------------------------------------------------------------
    def _affinity_score(self, rep: "EngineReplica",
                        prompt: np.ndarray) -> int:
        eng = rep.engine
        if not eng.prefix_cache or eng.prefix is None:
            return 0
        _, skip, cow = eng.prefix.match(prompt)
        return int(skip) + (int(cow[1]) if cow else 0)

    def _place(self, req: Request,
               candidates: List["EngineReplica"]) -> "EngineReplica":
        if self.affinity:
            scored = [(self._affinity_score(r, req.prompt), r)
                      for r in candidates]
            best = max(s for s, _ in scored)
            if best > 0:
                # candidates come in registry member order, so min() keeps
                # the first of equal loads
                self.affinity_hits += 1
                return min((r for s, r in scored if s == best),
                           key=lambda r: r.load())
        return min(candidates, key=lambda r: r.load())

    # -- the dispatch path (chaos injection point) ---------------------------
    def dispatch(self, req: Request) -> int:
        """Place ``req`` on a replica and submit it; returns the replica
        id. Raises :class:`FleetUnavailable` when nothing admits."""
        while True:
            candidates = self.fleet.admitting()
            if not candidates:
                raise FleetUnavailable(
                    "no serving replica is admitting requests (all "
                    "draining or dead; raise HOROVOD_FLEET_MIN_REPLICAS "
                    "or grow the fleet)")
            rep = self._place(req, candidates)
            n = rep.dispatched_count
            delay = chaos.replica_slow_s(rep.rid, n)
            if delay > 0.0:
                self.slow_injected_s += delay
                time.sleep(delay)
            if chaos.on_replica_dispatch(rep.rid, n):
                # the chosen replica dies under us: reconcile (its queued
                # and in-flight work re-admits through this same router)
                # and re-route the undelivered request
                self.fleet.kill_replica(rep.rid, reason="chaos")
                continue
            self.dispatches += 1
            self.fleet.submit_on(rep, req)
            return rep.rid

    def stats(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "affinity": self.affinity,
            "affinity_hits": self.affinity_hits,
            "slow_injected_s": round(self.slow_injected_s, 6),
        }
