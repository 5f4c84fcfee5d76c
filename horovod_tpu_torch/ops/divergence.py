"""Cross-rank consistency check of the coordinator's deterministic dispatch.

The counterpart of ``horovod_tpu/ops/divergence.py``. Reference parity:
the coordinator rank validates that every rank submitted the same
dtype/shape/op/root for each named tensor and returns an ERROR response
naming the mismatch (reference: common/controller.cc:496-829
``ConstructResponse``: "Mismatched data types", "Mismatched ... shapes",
sent to all ranks); its stall inspector reports *which ranks* are missing
a tensor (common/stall_inspector.cc:26-80).

In a world of several ranks the port's coordinator dispatches
deterministically (``ops/coordinator.py``): it assumes every rank enqueues
the identical sequence. This module checks that assumption at every flush
point instead of trusting it: before a drained flush dispatches, each
rank publishes a digest of the flush's ordered request manifest
(name/op/dtype/shape/process set/root, with the checker's own cadence
state folded in last, so a desynced adaptive interval surfaces as an
immediate descriptive mismatch, not a timeout) to the c10d store of the
world (``utils/kvstore.distributed_kv``) and verifies every peer's digest.
On a mismatch, manifests are exchanged and every rank raises a
:class:`DivergenceError` naming the first divergent tensor and the
disagreeing ranks, where an unchecked dispatch would issue different
collectives on different ranks and hang NCCL. A peer that never reaches
the flush point within HOROVOD_DIVERGENCE_TIMEOUT raises too, after stall
warnings that name the lagging ranks.

**A widened cadence.** Once the interval has widened, a rank checks only
every few flushes, and an unseen signature snaps only its own cadence
back. So a rank that enqueues a new tensor checks a flush its peers
dispatch unchecked: they wait in a collective the checking rank never
enters. ``observe`` therefore returns a :class:`FlushWatch` for every flush
it does not check, and the coordinator waits on such a flush's
collectives through it. A wait that outlasts ``_WATCH_GRACE_S`` publishes
the flush's requests under a key of its own; a checking rank that finds
it names the first divergent request at once. Any rank that raises a
``DivergenceError`` publishes it under the generation's abort key, and a
watched wait that finds it raises too. So every rank raises, and none
waits in a collective longer than the timeout plus a poll. The
collectives a rank dispatched stay in flight: the world cannot go on
after a divergence.

A request's signature describes this rank's own tensor: its shape and the
numpy name of its dtype. An allgather's or alltoall's first dim may differ
between ranks (the reference validates it only for the other ops), so
their signatures give it as ``*``.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Callable, List, Optional, Sequence

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.stall")

# A wait on a flush dispatched unchecked: after _WATCH_GRACE_S it publishes
# the flush's requests and polls the abort key every _WATCH_POLL_S. A
# checking rank looks for such peers every _PEER_POLL_S of its wait.
_WATCH_GRACE_S = 0.5
_WATCH_POLL_S = 0.1
_PEER_POLL_S = 0.5


class DivergenceError(RuntimeError):
    """Ranks submitted different collective sequences (the analogue of the
    reference's mismatch ERROR response, controller.cc:496-829). Raised on
    every rank that participates in the failed check, so no rank is left
    deadlocked in a collective its peers never entered."""


def _shape_text(e) -> str:
    dims = [str(int(s)) for s in e.x.shape]
    if dims and e.op_type in ("allgather", "alltoall"):
        dims[0] = "*"           # may differ between ranks
    return "(" + ", ".join(dims) + ("," if len(dims) == 1 else "") + ")"


def dtype_name(dtype) -> str:
    """The numpy name of a torch dtype ('float32', 'bfloat16', ...)."""
    return str(dtype).replace("torch.", "")


def entry_signature(e) -> str:
    """Canonical one-line description of a queued request: everything that
    must agree across ranks for the dispatched collectives to match (the
    fields the reference validates in ConstructResponse, plus the
    fusion-relevant scale factors and group structure)."""
    pset = 0 if e.process_set is None else e.process_set.process_set_id
    op = getattr(e.op, "name", str(e.op))
    return (f"{e.name}|{e.op_type}|{op}|{dtype_name(e.x.dtype)}"
            f"|{_shape_text(e)}|ps{pset}"
            f"|root{e.root_rank}|pre{e.prescale_factor}"
            f"|post{e.postscale_factor}|grp{e.group_id}|j{e.joined}")


_NONAME_RE = None


def _steady_key(sig: str) -> str:
    """Normalize a signature for the steady-state cadence cache: strip the
    per-invocation group id and auto-name counter (eager auto-allocates
    both per call, so without this a grouped/unnamed-collective loop would
    register as fresh traffic on every flush and the cadence could never
    widen). The FULL signature still participates in the cross-rank
    digest."""
    global _NONAME_RE
    import re
    if _NONAME_RE is None:
        _NONAME_RE = (re.compile(r"\.noname\.\d+"),
                      re.compile(r"\|grp\d+"))
    sig = _NONAME_RE[0].sub(".noname.#", sig)
    return _NONAME_RE[1].sub("|grp#", sig)


class DivergenceChecker:
    """Per-flush digest exchange over the c10d store of the world.

    One instance per Coordinator in deterministic mode (several ranks).
    ``observe(flush_idx, entries)`` is called with each flush's drained
    entry list BEFORE dispatch; every HOROVOD_DIVERGENCE_CHECK_EVERY-th
    flush it exchanges digests covering all entries since the last check.
    Raises :class:`DivergenceError` on mismatch or peer timeout; dispatch
    must not proceed in either case.
    """

    def __init__(self, kv, process_index: int, process_count: int,
                 prefix: str = "hvd/divcheck",
                 clock: Callable[[], float] = time.monotonic,
                 wait: Optional[Callable[[str, float], Optional[str]]] = None):
        self._kv = kv
        self._pidx = int(process_index)
        self._nproc = int(process_count)
        self._prefix = prefix
        self._clock = clock
        # wait(key, seconds) -> value or None on timeout. The default rides
        # the KV store's blocking get so the waiter wakes the moment a peer
        # publishes (a fixed-interval poll would quantize every flush's
        # latency to the poll period while holding the cycle lock).
        self._wait = wait if wait is not None else self._kv_wait
        self._manifest: List[str] = []      # entries since last exchange
        self._check_idx = 0
        self.checks = 0                     # completed exchanges (tests)
        # Steady-state amortization (the reference's response-cache fast
        # path, response_cache.h:107: steady state costs one bitvector
        # allreduce, anything uncached forces the slow path): after
        # _STREAK consecutive clean exchanges the effective interval
        # doubles, up to HOROVOD_DIVERGENCE_CHECK_MAX_INTERVAL; any new
        # request signature or a coordinator requeue/topology event snaps
        # it back to the HOROVOD_DIVERGENCE_CHECK_EVERY base.
        self._since_check = 0
        self._streak = 0
        self._effective: Optional[int] = None
        self._seen: dict = {}               # normalized signature LRU
        self._evictions = 0
        self._thrash_warned = False

    _STREAK = 3                             # clean checks per doubling

    def _kv_wait(self, key: str, seconds: float) -> Optional[str]:
        try:
            return self._kv.get(key, max(seconds, 0.05))
        except Exception as e:
            kind = str(e).upper().replace(" ", "_")
            if isinstance(e, TimeoutError) or "DEADLINE" in kind \
                    or "TIMEOUT" in kind or "NOT_FOUND" in kind:
                return None
            raise               # transport failure: not 'peer is late'

    # -- keys ----------------------------------------------------------------
    def _dkey(self, check: int, pidx: int) -> str:
        return f"{self._prefix}/d/{check}/{pidx}"

    def _mkey(self, check: int, pidx: int) -> str:
        return f"{self._prefix}/m/{check}/{pidx}"

    def _wkey(self, flush: int, pidx: int) -> str:
        """A rank waiting in flush ``flush``, dispatched unchecked."""
        return f"{self._prefix}/w/{flush}/{pidx}"

    def _abort_key(self) -> str:
        return f"{self._prefix}/abort"

    def _fail(self, message: str) -> None:
        """Publish the failure for the watched waits of the peers, then
        raise it here."""
        try:
            self._kv.set(self._abort_key(), json.dumps(
                {"rank": self._pidx, "message": message}))
        except ValueError:      # write-once: a peer's abort is there first
            pass
        except Exception:                   # pragma: no cover - best effort
            logger.exception("could not publish the divergence abort")
        raise DivergenceError(message)

    # -- cadence -------------------------------------------------------------
    def reset_cadence(self) -> None:
        """Snap back to the base check interval — called on coordinator
        requeue/topology events and on any unseen request signature (the
        analogue of a response-cache miss forcing the slow path)."""
        self._streak = 0
        self._effective = None

    @property
    def effective_interval(self) -> int:
        return self._effective or int(
            knobs.get("HOROVOD_DIVERGENCE_CHECK_EVERY"))

    # -- main entry (coordinator cycle, before dispatch) ---------------------
    def observe(self, flush_idx: int, entries: Sequence
                ) -> Optional["FlushWatch"]:
        """Record a flush; check it when the cadence says so. Returns None
        for a checked flush (or with the check off), else the
        :class:`FlushWatch` its collectives are waited through."""
        every = int(knobs.get("HOROVOD_DIVERGENCE_CHECK_EVERY"))
        if every <= 0 or self._nproc <= 1:
            return None
        sigs = [entry_signature(e) for e in entries]
        lines = [f"{flush_idx}:{s}" for s in sigs]
        self._manifest.extend(lines)
        # Steady-state cache keys NORMALIZE per-invocation-unique fields
        # (auto-allocated group ids, '.noname.N' auto names) — the full
        # signature still goes into the digest manifest above, but a loop
        # of unnamed/grouped collectives must read as steady traffic, not
        # as a fresh signature every flush.
        keys = [_steady_key(s) for s in sigs]
        fresh = False
        cap = max(int(knobs.get("HOROVOD_CACHE_CAPACITY")), 16)
        for key in keys:
            if key in self._seen:
                self._seen.pop(key)         # refresh: true LRU recency
                self._seen[key] = True
                continue
            fresh = True
            self._seen[key] = True
            if len(self._seen) > cap:
                self._seen.pop(next(iter(self._seen)))
                self._evictions += 1
                if self._evictions == cap and not self._thrash_warned:
                    self._thrash_warned = True
                    logger.warning(
                        "divergence-check steady-state cache evicted %d "
                        "signatures (capacity %d, HOROVOD_CACHE_CAPACITY)"
                        " — the working set exceeds the cache, so the "
                        "check interval cannot amortize and stays at the "
                        "base cadence", self._evictions, cap)
        if fresh:
            self.reset_cadence()
        if self._effective is None:
            self._effective = every
        self._since_check += 1
        if self._since_check < self._effective:
            return FlushWatch(self, flush_idx, lines)
        self._since_check = 0
        self._exchange(flush_idx, lines)
        # Clean exchange: widen the steady-state interval.
        self._streak += 1
        if self._streak >= self._STREAK:
            self._streak = 0
            cap = max(int(knobs.get(
                "HOROVOD_DIVERGENCE_CHECK_MAX_INTERVAL")), every)
            self._effective = min(self._effective * 2, cap)
        return None

    # -- protocol ------------------------------------------------------------
    def _exchange(self, flush_idx: int, lines: List[str]) -> None:
        from horovod_tpu_torch.timeline import NEGOTIATE, get_timeline
        manifest, self._manifest = self._manifest, []
        self._check_idx += 1
        ck = self._check_idx
        # The cadence state is folded into the exchanged manifest: the
        # adaptive interval is rank-local (seen-signature cache, streaks,
        # requeue resets), and if it ever desyncs — per-rank
        # HOROVOD_DIVERGENCE_CHECK_* / HOROVOD_CACHE_CAPACITY env
        # differences, rank-local requeue nondeterminism — ranks would
        # exchange DIFFERENT flush windows under the same check index and
        # the mismatch would only surface as a misleading full-timeout
        # "never reached flush point" error. Digesting the cadence line
        # makes a desync an immediate descriptive mismatch instead. It
        # goes LAST so the first-divergent-entry detail still names the
        # offending tensor when a request divergence is the root cause
        # (a fresh signature resets only the diverged rank's cadence, so
        # the cadence line differs as a mere symptom then). (The cadence
        # knobs must be uniform across ranks.)
        manifest = manifest + [
            f"#cadence|effective={self.effective_interval}"
            f"|streak={self._streak}|window={len(manifest)}"]
        digest = hashlib.sha256("\n".join(manifest).encode()).hexdigest()
        self._kv.set(self._dkey(ck, self._pidx), digest)

        timeout = float(knobs.get("HOROVOD_DIVERGENCE_TIMEOUT"))
        warn_after = float(knobs.get("HOROVOD_STALL_CHECK_TIME_SECONDS"))
        deadline = self._clock() + timeout
        warn_at = self._clock() + warn_after
        peers = [p for p in range(self._nproc) if p != self._pidx]
        got = {}
        tl = get_timeline()
        if tl.active:
            tl.begin(f"flush_check_{ck}", NEGOTIATE)
        try:
            while True:
                for p in peers:
                    if p not in got:
                        v = self._kv.try_get(self._dkey(ck, p))
                        if v is not None:
                            got[p] = v
                missing = [p for p in peers if p not in got]
                if not missing:
                    break
                now = self._clock()
                if now < warn_at and now < deadline:
                    # Block on the first missing peer's key until the next
                    # warn/deadline boundary; a publish wakes us instantly.
                    # Between blocks, look for peers that dispatched this
                    # flush unchecked and wait in its collectives.
                    chunk = min(warn_at, deadline) - now
                    v = self._wait(self._dkey(ck, missing[0]),
                                   min(chunk, _PEER_POLL_S))
                    if v is not None:
                        got[missing[0]] = v
                    else:
                        self._raise_if_unchecked_peers(ck, flush_idx, lines,
                                                       missing)
                    continue
                if now >= warn_at:
                    # Cross-rank stall attribution (ref
                    # stall_inspector.cc:26-80 "missing ranks" report).
                    logger.warning(
                        "flush check %d: ranks %s have not reached this "
                        "flush point after %.0fs (ranks %s have); waiting "
                        "tensors: %s", ck, missing, warn_after,
                        sorted([self._pidx] + list(got)),
                        [m.split("|", 1)[0] for m in manifest[:5]
                         if not m.startswith("#cadence")])
                    warn_at = now + warn_after
                if now >= deadline:
                    names = [m.split("|", 1)[0] for m in manifest[:10]
                             if not m.startswith("#cadence")]
                    self._fail(
                        f"ranks {missing} never reached collective flush "
                        f"point {ck} within {timeout:.0f}s (ranks "
                        f"{sorted([self._pidx] + list(got))} did). The "
                        f"rank programs have diverged — each rank must "
                        f"enqueue the identical collective sequence. "
                        f"Tensors at this flush: {names}")
        finally:
            if tl.active:
                tl.end(f"flush_check_{ck}", NEGOTIATE,
                       args={"manifest_len": len(manifest) - 1,  # - cadence
                             "peers_seen": sorted(got)})

        bad = sorted(p for p, v in got.items() if v != digest)
        if bad:
            self._raise_mismatch(ck, manifest, bad)
        # Passed: prune this rank's keys from two checks ago (any peer
        # still needing them is at most one check behind, or the timeout
        # above would have fired).
        if ck > 2:
            self._kv.delete(self._dkey(ck - 2, self._pidx))
            self._kv.delete(self._mkey(ck - 2, self._pidx))
        self.checks += 1

    @staticmethod
    def _split_cadence(manifest: List[str]):
        """(request lines, cadence sentinel or '') — the sentinel is
        manifest data for the digest but must not be counted or named as
        a submitted collective in operator-facing attribution."""
        reqs = [m for m in manifest if not m.startswith("#cadence")]
        cad = next((m for m in manifest if m.startswith("#cadence")), "")
        return reqs, cad

    def _raise_if_unchecked_peers(self, ck: int, flush_idx: int,
                                  lines: List[str], missing: List[int]
                                  ) -> None:
        """Raise when one of the ``missing`` peers dispatched this flush
        without a check (its watched wait published the flush's
        requests), naming the first divergent request."""
        found = {}
        for p in missing:
            v = self._kv.try_get(self._wkey(flush_idx, p))
            if v is not None:
                found[p] = json.loads(v)
        if not found:
            return
        bad = sorted(found)
        detail = self._request_detail(lines, found[bad[0]], bad[0]) or \
            "the flush's requests match, the check cadence does not"
        self._fail(
            f"collective flush {flush_idx} diverged across ranks: rank "
            f"{self._pidx} checks it (check {ck}), rank(s) {bad} dispatched "
            f"it unchecked at a widened check interval; {detail}. Every "
            f"rank must enqueue the identical sequence of collectives (ref "
            f"controller.cc:496 mismatch ERROR).")

    def _request_detail(self, reqs: List[str], oreqs: List[str],
                        other: int) -> str:
        """The first request where this rank's ``reqs`` and rank
        ``other``'s ``oreqs`` part, or '' when they agree."""
        n = min(len(reqs), len(oreqs))
        idx = next((i for i in range(n) if reqs[i] != oreqs[i]), n)
        if idx < n:
            return (f"first divergent request #{idx}: this rank submitted "
                    f"[{reqs[idx]}], rank {other} submitted [{oreqs[idx]}]")
        if len(reqs) != len(oreqs):
            longer = self._pidx if len(reqs) > len(oreqs) else other
            extra = (reqs if len(reqs) > len(oreqs) else oreqs)[n]
            return (f"rank {longer} submitted {abs(len(reqs) - len(oreqs))} "
                    f"extra request(s) starting with [{extra}]")
        return ""

    def _raise_mismatch(self, ck: int, manifest: List[str],
                        bad: List[int]) -> None:
        """Exchange full manifests with the first disagreeing rank and name
        the first divergent request (the reference names the mismatched
        tensor in its ERROR response, controller.cc:527-630) — or the
        diverged cadence state when the requests themselves agree."""
        self._kv.set(self._mkey(ck, self._pidx), json.dumps(manifest))
        detail = ""
        reqs, cad = self._split_cadence(manifest)
        try:
            raw = json.loads(self._kv.get(self._mkey(ck, bad[0]), 30.0))
        except Exception:
            raw = None
        if raw is not None:
            oreqs, ocad = self._split_cadence(raw)
            detail = self._request_detail(reqs, oreqs, bad[0])
            if not detail and cad != ocad:
                detail = (f"the submitted requests MATCH but the check-"
                          f"cadence state diverged")
            if cad != ocad:
                detail += (f"{'; ' if detail else ''}check-cadence state: "
                           f"this rank [{cad}], rank {bad[0]} [{ocad}] — "
                           f"per-rank HOROVOD_DIVERGENCE_CHECK_*/"
                           f"HOROVOD_CACHE_CAPACITY settings must be "
                           f"identical")
        self._fail(
            f"collective flush {ck} diverged across ranks: rank "
            f"{self._pidx} disagrees with rank(s) {bad} on the submitted "
            f"collective sequence ({len(reqs)} requests on this rank). "
            + (detail or "manifest fetch from the disagreeing rank failed; "
                         "digests differ.")
            + " Every rank must enqueue the identical sequence of "
              "collectives (ref controller.cc:496 mismatch ERROR).")


class FlushWatch:
    """The wait on a flush this rank dispatched without a check (module
    docstring): ``wait_until(done)`` returns once ``done()`` is true, or
    raises the :class:`DivergenceError` a peer published."""

    __slots__ = ("_checker", "flush", "_lines", "_published")

    def __init__(self, checker: DivergenceChecker, flush: int,
                 lines: List[str]):
        self._checker = checker
        self.flush = flush
        self._lines = lines
        self._published = False

    def wait_until(self, done: Callable[[], bool]) -> None:
        chk = self._checker
        t0 = chk._clock()
        nap, polled = 1e-5, t0
        while not done():
            now = chk._clock()
            if now - t0 < _WATCH_GRACE_S:
                nap = min(nap * 2, 2e-4)    # a healthy flush ends here
            else:
                if not self._published:
                    self._published = True
                    chk._kv.set(chk._wkey(self.flush, chk._pidx),
                                json.dumps(self._lines))
                if now - polled >= _WATCH_POLL_S:
                    polled = now
                    self._raise_if_aborted()
                nap = _WATCH_POLL_S / 4
            time.sleep(nap)
        if self._published:     # done late: was it a peer's collective?
            self._raise_if_aborted()

    def _raise_if_aborted(self) -> None:
        chk = self._checker
        v = chk._kv.try_get(chk._abort_key())
        if v is None:
            return
        rec = json.loads(v)
        raise DivergenceError(
            f"rank {rec['rank']} raised DivergenceError while rank "
            f"{chk._pidx} waited on flush {self.flush}, which it had "
            f"dispatched without a check (the check interval had widened "
            f"to {chk.effective_interval}): {rec['message']}")
