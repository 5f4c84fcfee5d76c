"""hvdfault: the unified fault-domain runtime.

The port's copy of ``horovod_tpu/resilience/faults.py``, with the same
names, sites and semantics, so a retry schedule replays bit for bit in
both packages.

**Retry policies** (:class:`RetryPolicy`, :func:`retry_call`): every
control-plane transport call (the c10d store, the checkpoint commit
renames) runs under a per-call-site policy: a total deadline budget,
capped exponential backoff with *deterministic* jitter (seeded by call
site + attempt, so two ranks never sync their retry storms yet a replayed
schedule is bit-identical), and an attempt ceiling. Defaults come from the
``HOROVOD_FAULT_*`` knobs; per-site overrides from
``HOROVOD_FAULT_POLICIES`` JSON or :func:`register_policy`.

**RetryingKV**: the wrapper every KV consumer routes through
(``utils.kvstore.distributed_kv(site=...)`` returns one). Transient
transport failures (``UNAVAILABLE``, connection resets) are retried under
the site's policy; semantic outcomes (``NOT_FOUND``, ``ALREADY_EXISTS`` —
a peer winning a write-once race, a blocking get's own
``DEADLINE_EXCEEDED``) propagate immediately, because retrying them would
change protocol meaning, not availability.

**The fault domain** (:class:`FaultDomain`): ``healthy -> degraded ->
draining``. When a retry budget exhausts on an *optional* site the process
does not die: it enters ``degraded`` and sheds that site's traffic
(straggler exchange, metrics publish) while *protocol-critical* paths
(checkpoint commit barrier, preemption stop step) keep their full deadline
and fail loudly with a flight recording. Shed sites are probed on a
cadence (``HOROVOD_FAULT_PROBE_SECONDS``); one success heals the site, an
empty shed set restores ``healthy``. The state is published as the
``hvd_fault_domain_state`` gauge and as the ``fault_domain`` block of
``/healthz`` (``metrics.health_snapshot``).
"""

from __future__ import annotations

import dataclasses
import errno
import hashlib
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.utils import schedhooks
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.resilience")

# Fault-domain states (gauge values — hvd_fault_domain_state).
HEALTHY, DEGRADED, DRAINING = "healthy", "degraded", "draining"
_STATE_VALUE = {HEALTHY: 0, DEGRADED: 1, DRAINING: 2}

# Sites whose traffic is OPTIONAL: exhausting their retry budget degrades
# the process instead of failing it, and degraded mode sheds them. Every
# other registered site is protocol-critical — a lost commit barrier or
# stop-step agreement must fail loudly, never silently shed.
SHEDDABLE_SITES = frozenset(
    {"metrics", "trace_merge", "straggler", "autotune",
     "elastic_notification",
     # numerics: not a KV consumer — the site the numerics monitor
     # (goodput/numerics.py) sheds under HOROVOD_NUMERICS_ACTION=degrade
     # so a detector firing flips /healthz to degraded (and a clean
     # check heals it) without killing the run.
     "numerics",
     # artifact_store: disk I/O of the persistent compiled-artifact
     # store (store/artifact_store.py) — a store that cannot be read or
     # written degrades to compile-as-usual, never fails the run.
     "artifact_store"})

# The KV consumers of the JAX package: each names its site when calling
# utils.kvstore.distributed_kv(site=...), and the registry below seeds a
# policy for each. The port's consumers are checkpoint_commit, preemption
# and straggler; the others keep their policies so a HOROVOD_FAULT_POLICIES
# written for the JAX package configures both.
KV_CONSUMER_SITES = (
    "autotune",               # autotune.ParameterSynchronizer + bucket bcast
    "divergence",             # ops/divergence digest exchange
    "metrics",                # metrics.ClusterAggregator publish/merge
    "checkpoint_commit",      # async_checkpoint multihost commit barrier
    "preemption",             # preemption stop-step agreement
    "trace_merge",            # tracing/merge summaries
    "straggler",              # tracing/straggler skew exchange
    "elastic_notification",   # elastic driver hosts-updated KV mirror
    "verify",                 # analysis/ir HVD503 order exchange
    "resize",                 # elastic/resize ResizeAgreement plan + barrier
)

# Errno values retried on filesystem paths (retry_fs): the transient
# classes a networked/contended filesystem actually throws. ENOSPC and
# EACCES are NOT here — retrying them burns the deadline on a condition
# that needs an operator.
_TRANSIENT_ERRNOS = frozenset({
    errno.EIO, errno.EAGAIN, errno.EBUSY, errno.ETIMEDOUT, errno.ESTALE,
    errno.EINTR,
})

_TRANSIENT_TOKENS = ("UNAVAILABLE", "CONNECTION", "UNREACHABLE",
                     "RESET", "BROKEN_PIPE", "TRY_AGAIN", "ABORTED")


class RetryBudgetExhausted(RuntimeError):
    """A call site's retry policy ran out of deadline/attempts. Carries
    the site and the last underlying error (``__cause__``)."""

    def __init__(self, site: str, attempts: int, elapsed_s: float,
                 last: BaseException):
        super().__init__(
            f"retry budget exhausted for site {site!r}: {attempts} "
            f"attempts over {elapsed_s:.2f}s; last error: {last}")
        self.site = site
        self.attempts = attempts


def is_transient(exc: BaseException) -> bool:
    """Transport-level failure worth retrying. Semantic outcomes
    (NOT_FOUND, ALREADY_EXISTS, DEADLINE_EXCEEDED of a blocking get)
    are deliberately NOT transient — retrying them changes protocol
    meaning."""
    if isinstance(exc, (ConnectionError, BrokenPipeError)):
        return True
    if isinstance(exc, OSError):
        return exc.errno in _TRANSIENT_ERRNOS
    text = str(exc).upper().replace(" ", "_")
    if "NOT_FOUND" in text or "ALREADY_EXISTS" in text \
            or "DEADLINE_EXCEEDED" in text:
        return False
    return any(tok in text for tok in _TRANSIENT_TOKENS)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-call-site retry behavior. ``deadline_s`` is the TOTAL budget
    across attempts (backoff included); ``max_attempts`` bounds the loop
    even when individual failures return instantly."""

    site: str
    deadline_s: float
    base_backoff_s: float = 0.1
    max_backoff_s: float = 5.0
    multiplier: float = 2.0
    max_attempts: int = 5
    jitter: float = 0.2
    critical: bool = True

    def backoff_s(self, attempt: int) -> float:
        """Capped exponential backoff with DETERMINISTIC jitter: the
        jitter fraction comes from sha256(site, attempt), so a replay
        (chaos run, hvdmodel schedule) is bit-identical while distinct
        sites/attempts still decorrelate their retry storms."""
        raw = self.base_backoff_s * (self.multiplier ** attempt)
        capped = min(raw, self.max_backoff_s)
        if self.jitter <= 0 or capped <= 0:
            return capped
        digest = hashlib.sha256(
            f"{self.site}:{attempt}".encode()).digest()
        frac = int.from_bytes(digest[:4], "big") / 0xFFFFFFFF
        return capped * (1.0 - self.jitter * frac)


_policies: Dict[str, RetryPolicy] = {}
_policies_lock = threading.Lock()
_env_overrides_loaded = False


def _default_policy(site: str) -> RetryPolicy:
    return RetryPolicy(
        site=site,
        deadline_s=float(knobs.get("HOROVOD_FAULT_RETRY_DEADLINE")),
        base_backoff_s=float(knobs.get("HOROVOD_FAULT_RETRY_BASE")),
        max_backoff_s=float(knobs.get("HOROVOD_FAULT_RETRY_MAX_BACKOFF")),
        max_attempts=int(knobs.get("HOROVOD_FAULT_RETRIES")),
        jitter=float(knobs.get("HOROVOD_FAULT_RETRY_JITTER")),
        critical=site not in SHEDDABLE_SITES)


def _load_env_overrides() -> None:
    """HOROVOD_FAULT_POLICIES: JSON {site: {field: value}} merged over
    the knob-derived defaults, once per process (register_policy still
    wins afterwards)."""
    global _env_overrides_loaded
    if _env_overrides_loaded:
        return
    _env_overrides_loaded = True
    raw = knobs.get("HOROVOD_FAULT_POLICIES")
    if not raw:
        return
    try:
        spec = json.loads(raw)
    except (TypeError, ValueError):
        logger.warning("HOROVOD_FAULT_POLICIES is not valid JSON; "
                       "ignoring: %r", raw)
        return
    for site, fields in spec.items():
        base = _policies.get(site) or _default_policy(site)
        try:
            _policies[site] = dataclasses.replace(base, **fields)
        except TypeError as e:
            logger.warning("HOROVOD_FAULT_POLICIES[%s] has unknown "
                           "fields (%s); ignoring that entry", site, e)


def register_policy(policy: RetryPolicy) -> RetryPolicy:
    """Install/replace the policy for ``policy.site``."""
    with _policies_lock:
        _load_env_overrides()
        _policies[policy.site] = policy
    return policy


def policy_for(site: str) -> RetryPolicy:
    """The registered policy for ``site``; unseen sites get the
    knob-derived default (critical unless listed in SHEDDABLE_SITES)."""
    with _policies_lock:
        _load_env_overrides()
        pol = _policies.get(site)
        if pol is None:
            pol = _default_policy(site)
            _policies[site] = pol
        return pol


def registered_sites() -> List[str]:
    # Sheddable non-KV sites (numerics) are part of the catalog too:
    # every site the fault domain can shed must be a known site.
    with _policies_lock:
        _load_env_overrides()
        return sorted(set(_policies) | set(KV_CONSUMER_SITES)
                      | SHEDDABLE_SITES)


# ---------------------------------------------------------------------------
# metrics (lazy: faults must stay importable before/without the metrics
# plane — and metrics itself consults the fault domain for /healthz)
# ---------------------------------------------------------------------------

def _m_attempts():
    from horovod_tpu_torch import metrics as M
    return M.counter("hvd_retry_attempts_total",
                     "Retries issued (first attempts not counted)",
                     labelnames=("site",))


def _m_exhausted():
    from horovod_tpu_torch import metrics as M
    return M.counter("hvd_retry_exhausted_total",
                     "Retry budgets exhausted", labelnames=("site",))


def _m_shed():
    from horovod_tpu_torch import metrics as M
    return M.counter("hvd_fault_shed_total",
                     "Operations shed while their site was degraded",
                     labelnames=("site",))


def _m_state():
    from horovod_tpu_torch import metrics as M
    return M.gauge("hvd_fault_domain_state",
                   "Fault-domain state: 0 healthy, 1 degraded, "
                   "2 draining", aggregation="leader")


# ---------------------------------------------------------------------------
# the fault domain
# ---------------------------------------------------------------------------

class FaultDomain:
    """Process-wide health state machine. ``healthy`` — all sites fine;
    ``degraded`` — at least one optional site shed after exhausting its
    retry budget (protocol-critical paths unaffected); ``draining`` —
    the process is winding down on purpose (armed preemption). Entering
    ``degraded`` dumps a flight recording once per episode: the spans
    leading up to the first exhausted budget are the diagnosis."""

    def __init__(self):
        self._lock = threading.Lock()
        # site -> monotonic time of the last probe permission
        self._shed: Dict[str, float] = {}
        # Own per-site tallies (mirroring the Prometheus counters):
        # /healthz reads THESE — snapshotting the whole metrics
        # registry per liveness probe would be needless work on a hot
        # endpoint.
        self._exhausted_counts: Dict[str, int] = {}
        self._attempt_counts: Dict[str, int] = {}
        self._shed_counts: Dict[str, int] = {}
        self._degraded_since: Optional[float] = None
        self._flight_dumped = False

    # -- state ---------------------------------------------------------------
    def state(self) -> str:
        from horovod_tpu_torch.resilience import preemption as _preemption
        h = _preemption.active_handler()
        if h is not None and h.requested:
            return DRAINING
        with self._lock:
            return DEGRADED if self._shed else HEALTHY

    def shed_sites(self) -> List[str]:
        with self._lock:
            return sorted(self._shed)

    def snapshot(self) -> Dict[str, Any]:
        """The /healthz ``fault_domain`` block."""
        with self._lock:
            shed = sorted(self._shed)
            since = self._degraded_since
            exhausted = dict(self._exhausted_counts)
        return {
            "state": self.state(),
            "shed": shed,
            "degraded_seconds": (round(time.monotonic() - since, 3)
                                 if since is not None and shed else 0.0),
            "exhausted_budgets": exhausted,
        }

    def record_attempt(self, site: str) -> None:
        with self._lock:
            self._attempt_counts[site] = \
                self._attempt_counts.get(site, 0) + 1

    def retry_summary(self) -> Dict[str, Dict[str, int]]:
        """Per-site attempt/exhausted/shed tallies (the /healthz
        ``fault_domain.retries`` block)."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for name, counts in (("attempts", self._attempt_counts),
                                 ("exhausted", self._exhausted_counts),
                                 ("shed", self._shed_counts)):
                if counts:
                    out[name] = dict(counts)
            return out

    def _publish_state(self) -> None:
        try:
            _m_state().set(_STATE_VALUE[self.state()])
        except Exception:   # metrics plane not up yet
            logger.debug("fault-domain gauge unavailable", exc_info=True)

    # -- transitions ---------------------------------------------------------
    def record_exhausted(self, site: str, critical: bool) -> None:
        """A retry budget ran dry. Optional site: shed it and degrade.
        Critical site: stay in the current state — the caller is about
        to fail loudly — but ship the flight recording either way."""
        with self._lock:
            self._exhausted_counts[site] = \
                self._exhausted_counts.get(site, 0) + 1
            newly_degraded = False
            if not critical and site not in self._shed:
                if not self._shed:
                    self._degraded_since = time.monotonic()
                # probe clock starts NOW: the budget that just exhausted
                # was itself the proof the site is down
                self._shed[site] = time.monotonic()
                newly_degraded = True
        try:
            _m_exhausted().labels(site=site).inc()
        except Exception:
            pass
        if newly_degraded:
            logger.warning(
                "fault domain DEGRADED: shedding optional site %r after "
                "its retry budget exhausted; protocol-critical paths "
                "keep their full deadlines (probe cadence %ss)",
                site, knobs.get("HOROVOD_FAULT_PROBE_SECONDS"))
        self._dump_flight_once(site)
        self._publish_state()

    def record_success(self, site: str) -> None:
        """A previously shed site answered: heal it. An empty shed set
        restores ``healthy`` (and re-arms the flight recorder for the
        next episode)."""
        with self._lock:
            if site not in self._shed:
                return
            del self._shed[site]
            healed_all = not self._shed
            if healed_all:
                self._degraded_since = None
                self._flight_dumped = False
        logger.warning("fault domain: site %r recovered%s", site,
                       "; state healthy" if healed_all else "")
        self._publish_state()

    def allow(self, site: str) -> bool:
        """False while ``site`` is shed — except one probe per
        ``HOROVOD_FAULT_PROBE_SECONDS``, which is how a brownout's end
        is ever observed."""
        with self._lock:
            last = self._shed.get(site)
            if last is None:
                return True
            now = time.monotonic()
            probe_every = float(knobs.get("HOROVOD_FAULT_PROBE_SECONDS"))
            if now - last >= probe_every:
                self._shed[site] = now
                return True
            self._shed_counts[site] = self._shed_counts.get(site, 0) + 1
        try:
            _m_shed().labels(site=site).inc()
        except Exception:
            pass
        return False

    def _dump_flight_once(self, site: str) -> None:
        if self._flight_dumped:
            return
        self._flight_dumped = True
        try:
            from horovod_tpu_torch.tracing import spans as trace
            trace.instant("fault.degraded", cat="fault",
                          attrs={"site": site})
            trace.dump_flight_recording(f"fault-degraded-{site}")
        except Exception:
            logger.debug("fault-domain flight dump failed", exc_info=True)


_domain = FaultDomain()


def fault_domain() -> FaultDomain:
    return _domain


def should_shed(site: str) -> bool:
    """Consumer-side gate for optional traffic: True when the fault
    domain is currently shedding ``site`` (and no probe is due). The
    periodic publishers (metrics, straggler, autotune sync, trace
    merge) check this before touching the transport."""
    return not _domain.allow(site)


def reset_for_tests() -> None:
    """Fresh policies + fault domain (unit tests only)."""
    global _domain, _env_overrides_loaded
    with _policies_lock:
        _policies.clear()
        _env_overrides_loaded = False
    _domain = FaultDomain()


# ---------------------------------------------------------------------------
# the retry engine
# ---------------------------------------------------------------------------

def retry_call(site: str, fn: Callable[[], Any], *,
               policy: Optional[RetryPolicy] = None,
               classify: Callable[[BaseException], bool] = is_transient,
               clock: Callable[[], float] = time.monotonic) -> Any:
    """Run ``fn()`` under ``site``'s retry policy: transient failures
    (per ``classify``) are retried with capped exponential backoff and
    deterministic jitter until the deadline or attempt budget runs out;
    non-transient errors propagate immediately. On exhaustion the fault
    domain is informed (optional site → degraded; critical site → the
    :class:`RetryBudgetExhausted` carries the last error and the caller
    fails loudly)."""
    pol = policy or policy_for(site)
    start = clock()
    attempt = 0
    while True:
        try:
            result = fn()
        except BaseException as e:
            if not classify(e):
                raise
            attempt += 1
            elapsed = clock() - start
            backoff = pol.backoff_s(attempt - 1)
            out_of_budget = (attempt >= pol.max_attempts
                             or elapsed + backoff > pol.deadline_s)
            if out_of_budget:
                _domain.record_exhausted(site, pol.critical)
                raise RetryBudgetExhausted(site, attempt, elapsed, e) from e
            _domain.record_attempt(site)
            try:
                _m_attempts().labels(site=site).inc()
            except Exception:
                pass
            logger.debug("transient failure at site %r (attempt %d, "
                         "backoff %.3fs): %s", site, attempt, backoff, e)
            schedhooks.sleep(backoff)
            # Goodput fold: backoff sleep is degraded/retry wall time —
            # reattribute it out of the ambient phase (clamped; no-op
            # when accounting is off).
            from horovod_tpu_torch.goodput import accountant as _goodput
            _goodput.carve(_goodput.DEGRADED, backoff)
            continue
        _domain.record_success(site)
        return result


def retry_fs(site: str, fn: Callable[[], Any]) -> Any:
    """Filesystem flavor of :func:`retry_call`: retries only the
    transient errno classes (EIO/EAGAIN/EBUSY/ETIMEDOUT/ESTALE/EINTR) —
    a full disk or a permission error is an operator problem, not
    weather."""

    def _fs_transient(e: BaseException) -> bool:
        return isinstance(e, OSError) and e.errno in _TRANSIENT_ERRNOS

    return retry_call(site, fn, classify=_fs_transient)


# ---------------------------------------------------------------------------
# RetryingKV — the wrapper all nine KV consumers route through
# ---------------------------------------------------------------------------

class RetryingKV:
    """``utils.kvstore.DistributedKV`` under a site's retry policy.
    Interface-identical to the raw wrapper; ``.inner`` and ``.site``
    are exposed for tests and for consumers that need the raw client.

    Retry semantics per operation:

    - ``set``: transient errors retried. ``ALREADY_EXISTS`` propagates —
      on a write-once key it may mean a *peer* won the race OR our own
      first attempt landed before its ack was lost; both read back the
      agreed value, which is exactly what every write-once consumer
      (stop-step, divergence) already does.
    - ``get``: transient errors retried; the blocking get's own
      ``DEADLINE_EXCEEDED``/timeout propagates (the key genuinely has
      not appeared — retrying would silently double the caller's wait).
    - ``try_get``: transient errors retried; NOT_FOUND stays ``None``.
    - ``delete``: best-effort by contract — one attempt, failures
      logged + counted by the inner wrapper, never raised.
    """

    def __init__(self, inner: Any, site: str = "kv",
                 policy: Optional[RetryPolicy] = None):
        self.inner = inner
        self.site = site
        self._policy = policy or policy_for(site)

    @property
    def policy(self) -> RetryPolicy:
        return self._policy

    def set(self, key: str, value: str, overwrite: bool = False) -> None:
        retry_call(self.site,
                   lambda: self.inner.set(key, value, overwrite=overwrite),
                   policy=self._policy)

    def get(self, key: str, timeout_s: float) -> str:
        return retry_call(self.site,
                          lambda: self.inner.get(key, timeout_s),
                          policy=self._policy)

    def try_get(self, key: str) -> Optional[str]:
        return retry_call(self.site, lambda: self.inner.try_get(key),
                          policy=self._policy)

    def delete(self, key: str) -> None:
        self.inner.delete(key)
