"""Continuous-batching scheduler (iteration-level scheduling, Orca
OSDI '22) over a :class:`~horovod_tpu_torch.serving.engine.ServeEngine`.

The counterpart of ``horovod_tpu/serving/scheduler.py``. Every engine step
boundary is a scheduling point:

1. **retire** slots whose request finished (max_new_tokens or EOS);
   their pages return to the free list immediately;
2. **admit** queued requests into free slots while both a slot and the
   worst-case page reservation are available; each admitted request
   prefills one chunk per cycle and records TTFT at its first token;
3. **decode** one batched step across all occupied slots.

``mode="static"`` is the baseline: admit only when every slot is free
and run the whole batch to completion.

Speculative decoding (``HOROVOD_SERVE_DRAFT`` set): the decode point
becomes draft-then-verify. A drafter proposes K tokens per slot (the
host-side :class:`NGramDrafter`, or the engine's truncated-layer draft)
and one batched verify step scores all K+1 positions per slot. Draft i
is accepted while it equals the token the verify step emitted one
position earlier, so the committed tokens are the sequential-decode
tokens, 1 to K+1 a step; EOS and the generation cap cut the accepted run
where sequential decode would stop, and the rejected suffix rolls the
slot's length back (``engine.rollback``). The tokens are the sequential
ones bitwise, on the CPU and on CUDA: the verify step takes the one GEMM
whose last bits depend on M on an H100 (the MLP's output product) in
chunks of the decode step's shape (``engine.spec_step``).

The ``hvd_serve_*`` metrics (requests by lifecycle edge, prefill and
decode tokens, queue depth, batch occupancy, and TTFT and TPOT on
``metrics.LATENCY_BUCKETS``) are observed where the JAX scheduler
observes them.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.serving.engine import ServeEngine
from horovod_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Request:
    """One generation request. ``prompt`` is a 1-D int32 token array;
    results accumulate in place as the scheduler advances it.
    ``arrival`` is an open-loop offset for ``run(traffic)``; left None,
    ``submit()`` stamps it, so TTFT includes the queue wait."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int = 0                 # 0 = HOROVOD_SERVE_MAX_NEW_TOKENS
    eos_token: Optional[int] = None
    arrival: Optional[float] = None
    # -- filled by the scheduler --
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft: Optional[float] = None            # arrival -> first token
    tpot: List[float] = dataclasses.field(default_factory=list)
    finished_at: Optional[float] = None
    slot: Optional[int] = None
    error: Optional[str] = None             # rejected requests carry why
    _last_token_t: float = 0.0
    _prefill_pos: int = 0                   # next prompt offset to prefill

    @property
    def done(self) -> bool:
        return self.finished_at is not None


def _metrics():
    from horovod_tpu_torch import metrics as M
    return {
        "requests": M.counter(
            "hvd_serve_requests_total",
            "Serving requests by lifecycle edge",
            labelnames=("event",)),
        "tokens": M.counter(
            "hvd_serve_tokens_total",
            "Tokens through the serving engine",
            labelnames=("kind",)),
        "queue": M.gauge(
            "hvd_serve_queue_depth",
            "Requests admitted to the scheduler but not yet in a "
            "decode slot"),
        "occupancy": M.gauge(
            "hvd_serve_batch_occupancy",
            "Occupied fraction of the decode batch slots",
            aggregation="leader"),
        "ttft": M.histogram(
            "hvd_serve_ttft_seconds",
            "Time to first token (arrival -> first generated token, "
            "queue wait included)", buckets=M.LATENCY_BUCKETS),
        "tpot": M.histogram(
            "hvd_serve_tpot_seconds",
            "Time per output token during decode (inter-token "
            "interval)", buckets=M.LATENCY_BUCKETS),
    }


class NGramDrafter:
    """Host-side n-gram drafter: propose the K tokens that followed the
    most recent earlier occurrence of the request's current n-token
    suffix (prompt + generated history), falling back to shorter
    suffixes down to a single token, and padding with the last proposed
    (or last seen) token. No device work; a wrong guess costs its row in
    the fixed-shape verify batch."""

    def __init__(self, n: int = 3):
        self.n = max(int(n), 1)

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        h = [int(t) for t in history]
        out: List[int] = []
        for n in range(min(self.n, max(len(h) - 1, 0)), 0, -1):
            tail = h[-n:]
            for i in range(len(h) - n - 1, -1, -1):
                if h[i:i + n] == tail:
                    out = h[i + n:i + n + k]
                    break
            if out:
                break
        last = h[-1] if h else 0
        while len(out) < k:
            out.append(out[-1] if out else last)
        return out[:k]


class ServeScheduler:
    """Single-threaded scheduling loop over one engine. ``device`` names
    the device the engine serves on (default ``"cuda"``, which raises
    without a GPU); it must match the engine's."""

    def __init__(self, engine: ServeEngine, mode: str = "continuous",
                 queue_deadline: Optional[float] = None, *,
                 device="cuda"):
        if mode not in ("continuous", "static"):
            raise ValueError(f"unknown scheduler mode {mode!r}")
        dev = resolve_device(device)
        if dev.type != engine.device.type or (
                dev.index is not None and dev != engine.device):
            raise ValueError(
                f"ServeScheduler(device={str(device)!r}) over an engine "
                f"on {engine.device}")
        self.engine = engine
        self.mode = mode
        self.queue_deadline = float(
            queue_deadline if queue_deadline is not None
            else knobs.get("HOROVOD_SERVE_QUEUE_DEADLINE"))
        self.default_max_new = int(
            knobs.get("HOROVOD_SERVE_MAX_NEW_TOKENS"))
        self.queue: Deque[Request] = deque()
        self.prefilling: Dict[int, Request] = {}    # slot -> request
        self.active: Dict[int, Request] = {}        # slot -> request
        self.completed: List[Request] = []
        self._m = _metrics()
        self._decode_steps = 0
        self._occ_sum = 0.0
        self.queue_peak = 0
        # speculative tallies
        self._spec = engine.spec_k > 0
        self._ngram = (NGramDrafter(engine.draft_n)
                       if engine.draft_mode == "ngram" else None)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.prompt_tokens = 0
        self.cached_tokens = 0
        _register_scheduler(self)

    # -- intake --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.max_new_tokens <= 0:
            req.max_new_tokens = self.default_max_new
        if req.arrival is None:
            req.arrival = time.perf_counter()
        self.queue.append(req)
        self.queue_peak = max(self.queue_peak, len(self.queue))
        self._m["requests"].labels(event="submitted").inc()
        self._m["queue"].set(len(self.queue))

    # -- scheduling points ---------------------------------------------------
    def _retire(self, now: float) -> None:
        for slot, req in list(self.active.items()):
            hit_eos = (req.eos_token is not None and req.tokens
                       and req.tokens[-1] == req.eos_token)
            if len(req.tokens) >= req.max_new_tokens or hit_eos:
                req.finished_at = now
                self.engine.release(slot)       # eviction-on-finish
                del self.active[slot]
                self.completed.append(req)
                self._m["requests"].labels(event="completed").inc()

    def _admit(self, now: float) -> None:
        if self.mode == "static" and (self.active or self.prefilling):
            return                  # static baseline: whole-batch cycles
        while self.queue:
            req = self.queue[0]
            reject = None
            if int(req.prompt.size) > self.engine.max_seq:
                reject = (
                    f"prompt of {req.prompt.size} tokens exceeds the "
                    f"serving context ceiling {self.engine.max_seq} "
                    f"({self.engine.ceiling_hint})")
            else:
                # clamp generation to the context ceiling: decoding past
                # the last reserved page would corrupt the request's cache
                req.max_new_tokens = min(
                    int(req.max_new_tokens),
                    max(self.engine.max_seq - int(req.prompt.size), 0))
            worst = int(req.prompt.size) + int(req.max_new_tokens)
            pool = self.engine.pool
            if reject is None and pool.pages_for(worst) > pool.n_pages:
                # bigger than the whole pool: waiting would block the
                # queue forever
                reject = (
                    f"request needs {pool.pages_for(worst)} KV pages "
                    f"for its worst case of {worst} tokens but the pool "
                    f"holds only {pool.n_pages} "
                    f"(raise HOROVOD_SERVE_PAGES or lower the request's "
                    f"max_new_tokens)")
            if reject is not None:
                self.queue.popleft()
                req.error = reject
                req.finished_at = now
                self.completed.append(req)
                self._m["requests"].labels(event="rejected").inc()
                self._m["queue"].set(len(self.queue))
                continue
            slot = self.engine.reserve(worst, prompt=req.prompt)
            if slot is None:
                break               # no slot / pages: wait for a finish
            self.queue.popleft()
            self._m["queue"].set(len(self.queue))
            req.slot = slot
            # shared-prefix reuse: prefill starts past the cached tokens
            req._prefill_pos = int(self.engine.slot_skip[slot])
            self.prompt_tokens += int(req.prompt.size)
            self.cached_tokens += req._prefill_pos
            self.prefilling[slot] = req
            self._m["requests"].labels(event="admitted").inc()

    def _prefill_cycle(self) -> None:
        """Advance every admitted-but-unprefilled request by exactly ONE
        chunk, so a decode step runs between consecutive chunks."""
        for slot, req in list(self.prefilling.items()):
            old = req._prefill_pos
            pos, first = self.engine.prefill_chunk(slot, req.prompt, old)
            req._prefill_pos = pos
            self._m["tokens"].labels(kind="prefill").inc(pos - old)
            if first is None:
                continue
            del self.prefilling[slot]
            req.tokens.append(first)
            t = time.perf_counter()
            req.ttft = t - req.arrival if req.arrival is not None else 0.0
            req._last_token_t = t
            self.active[slot] = req
            self._m["ttft"].observe(max(req.ttft, 0.0))
            self._m["tokens"].labels(kind="decode").inc()

    def _decode(self) -> None:
        if not self.active:
            return
        if self._spec:
            self._decode_spec()
            return
        tokens = np.zeros((self.engine.slots,), np.int32)
        active = np.zeros((self.engine.slots,), bool)
        for slot, req in self.active.items():
            tokens[slot] = req.tokens[-1]
            active[slot] = True
        nxt = self.engine.decode_step(tokens, active=active)
        t = time.perf_counter()
        self._decode_steps += 1
        occ = self.engine.occupancy()
        self._occ_sum += occ
        self._m["occupancy"].set(occ)
        for slot, req in self.active.items():
            dt = t - req._last_token_t
            req.tokens.append(int(nxt[slot]))
            req.tpot.append(dt)
            req._last_token_t = t
            self._m["tpot"].observe(dt)
            self._m["tokens"].labels(kind="decode").inc()

    def _decode_spec(self) -> None:
        """Draft-then-verify decode point, accept-prefix per slot: draft
        i is confirmed while it equals the verify step's own emission one
        position back, so the appended run is the sequential greedy
        sequence;
        EOS and the generation cap cut it where sequential decode would
        stop, and the rejected suffix rolls the slot's length back."""
        eng = self.engine
        k = eng.spec_k
        tokens = np.zeros((eng.slots,), np.int32)
        active = np.zeros((eng.slots,), bool)
        for slot, req in self.active.items():
            tokens[slot] = req.tokens[-1]
            active[slot] = True
        if self._ngram is not None:
            drafts = np.zeros((eng.slots, k), np.int32)
            for slot, req in self.active.items():
                hist = list(np.asarray(req.prompt).reshape(-1))
                hist += req.tokens
                drafts[slot] = self._ngram.propose(hist, k)
        else:
            drafts = eng.propose_drafts(tokens, active)
        out = eng.spec_step(tokens, drafts, active=active)  # [S, K+1]
        t = time.perf_counter()
        self._decode_steps += 1
        occ = eng.occupancy()
        self._occ_sum += occ
        self._m["occupancy"].set(occ)
        for slot, req in self.active.items():
            g = 0
            while g < k and int(drafts[slot, g]) == int(out[slot, g]):
                g += 1
            accepted = [int(x) for x in out[slot, :g + 1]]
            self.spec_proposed += k
            self.spec_accepted += g
            room = req.max_new_tokens - len(req.tokens)
            accepted = accepted[:max(room, 1)]
            if req.eos_token is not None and req.eos_token in accepted:
                accepted = accepted[:accepted.index(req.eos_token) + 1]
            n_new = len(accepted)
            eng.rollback(slot, (k + 1) - n_new)
            dt = t - req._last_token_t
            req.tokens.extend(accepted)
            req.tpot.extend([dt / n_new] * n_new)
            req._last_token_t = t
            self._m["tpot"].observe(dt / n_new)
            self._m["tokens"].labels(kind="decode").inc(n_new)

    def step(self, now: Optional[float] = None) -> None:
        """One scheduling cycle: retire -> admit -> one prefill chunk per
        admitted request -> one decode step. The retire between prefill
        and decode keeps a request whose cap (or EOS) is met by its
        prefill token from decoding one token past it."""
        now = time.perf_counter() if now is None else now
        self._retire(now)
        self._admit(now)
        self._prefill_cycle()
        self._retire(time.perf_counter())
        self._decode()
        self._retire(time.perf_counter())

    def run(self, traffic=None) -> List[Request]:
        """Drive cycles until ``traffic`` is exhausted and every request
        completed. ``traffic`` is an optional iterable of Requests whose
        ``arrival`` timestamps are offsets from loop start (open loop)."""
        t0 = time.perf_counter()
        pending = deque(sorted(traffic or [],
                               key=lambda r: r.arrival or 0.0))
        for r in pending:
            r.arrival = t0 + (r.arrival or 0.0)  # offsets -> wall clock
        while pending or self.active or self.prefilling or self.queue:
            now = time.perf_counter()
            while pending and pending[0].arrival <= now:
                self.submit(pending.popleft())
            if not self.active and not self.prefilling and not self.queue:
                # every slot idle: the queue-deadline poll
                wait = min(pending[0].arrival - now,
                           max(self.queue_deadline, 1e-4))
                if wait > 0:
                    time.sleep(wait)
                continue
            self.step(now)
        self._m["occupancy"].set(self.engine.occupancy())
        return self.completed

    # -- reporting -----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        done = self.completed
        gen = sum(len(r.tokens) for r in done)
        return {
            "mode": self.mode,
            "queue_depth": len(self.queue),
            "active": len(self.active),
            "prefilling": len(self.prefilling),
            "completed": len(done),
            "generated_tokens": gen,
            "queue_peak": self.queue_peak,
            "decode_steps": self._decode_steps,
            "mean_occupancy": (round(self._occ_sum / self._decode_steps,
                                     4) if self._decode_steps else None),
            "prefix": ({
                "prompt_tokens": self.prompt_tokens,
                "cached_tokens": self.cached_tokens,
                "hit_rate": (round(self.cached_tokens
                                   / self.prompt_tokens, 4)
                             if self.prompt_tokens else None),
            } if self.engine.prefix_cache else None),
            "spec": ({
                "draft": self.engine.draft_spec,
                "k": self.engine.spec_k,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "acceptance_rate": (round(self.spec_accepted
                                          / self.spec_proposed, 4)
                                    if self.spec_proposed else None),
            } if self._spec else None),
        }


# ---------------------------------------------------------------------------
# module registry (the scheduler block of serving_stats())
# ---------------------------------------------------------------------------

_active_scheduler: Optional[ServeScheduler] = None


def _register_scheduler(s: ServeScheduler) -> None:
    global _active_scheduler
    _active_scheduler = s


def active_scheduler() -> Optional[ServeScheduler]:
    return _active_scheduler


def reset_for_tests() -> None:
    global _active_scheduler
    _active_scheduler = None
