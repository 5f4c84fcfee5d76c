"""Live world resize: shrink a running train loop without a respawn.

The counterpart of ``horovod_tpu/elastic/resize.py``. The elastic launcher
(runner/elastic_run.py) recovers from host loss by *respawning the
process tree*; this module takes a running world from N ranks to fewer
**in process**: on a host (or slice) loss the :class:`ResizeCoordinator`
runs the JAX package's six steps, in order, on torch's process model,
where a lost host's ranks are processes:

1. **quiesce** — the first rank observing the notice publishes a
   write-once plan (stop step = now + ``HOROVOD_ELASTIC_RESIZE_MARGIN``)
   on the c10d store (:class:`ResizeAgreement`, over
   ``utils/kvstore.distributed_kv(site="resize")``); every rank stops at
   the SAME step;
2. **drain** — outstanding eager handles are resolved with
   :class:`~horovod_tpu_torch.elastic.exceptions.ResizeInterrupt`
   (``eager.reset_outstanding``), and the coordinator's tuner trajectory
   is archived under its world key (``autotune.ParameterManager.
   archive_world_history``): the survivors' new coordinator, built for
   its own world, starts afresh, and one built for this world again
   resumes it;
3. **snapshot** — a final synchronous checkpoint commits at the stop step
   on the OLD world (every rank writes its shard), then the
   :class:`ResizePlan` commits atomically next to it
   (:func:`commit_plan_after_snapshot`: a committed plan always
   references a committed snapshot);
4. **leave** — while the old world still stands, every participant's
   per-rank state is gathered (the error-feedback residual of every rank,
   the samplers' processed sets); then the lost host's ranks shut down
   and :meth:`ResizeCoordinator.resize` returns :data:`LEFT` to them;
5. **rebuild** — the survivors destroy the old process group and form a
   new one, renumbered in old-rank order, on ``PrefixStore(
   "hvd/resize/<generation>", store)`` of the old store, then ``init``
   builds its topology (the DCN axis collapses when a whole slice died);
6. **reshard** — the residual is re-partitioned by the sum-into-successor
   policy (:func:`repartition_residual`, bitwise), every registered
   :class:`ResizeableState` (:class:`SamplerCarryover`) reshards, and the
   topology gauges and ``hvd_elastic_resizes_total{direction}`` /
   ``hvd_elastic_resize_seconds`` update at this commit point.

A process that boots straight into the small world restores the stop-step
snapshot through :func:`restore_resized`, which applies the same merge
from the shard files: bitwise the live path's state.

**The store.** The survivors keep the old store client. Under ``env://``
rank 0 hosts the ``TCPStore``, so outside the launcher a plan that removes
rank 0's host raises a descriptive error (ROADMAP C). ``hvdrun-torch``
hosts each generation's store itself and sets
``TORCHELASTIC_USE_AGENT_STORE=True``, under which every rank is a client
and any host may go.

Residual-merge policy (documented, deterministic, bitwise): a dead rank
``d``'s residual shard is added to the shard of its *successor* — the
smallest surviving old rank greater than ``d``, wrapping to the smallest
surviving rank. Dead ranks merge in ascending order. The SUM of the
residual tree is invariant under the merge.

A grow (``host_return``) needs processes that do not exist in this world:
the coordinator commits the snapshot and the plan, then raises
``HostsUpdatedInterrupt``; under ``elastic.run`` in a launched worker that
is the respawn (exit 73), and the next generation starts on the larger
world through :func:`restore_resized` (new ranks enter with a zero
residual).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from horovod_tpu_torch.config import knobs
from horovod_tpu_torch.elastic.exceptions import ResizeInterrupt
from horovod_tpu_torch.utils import schedhooks
from horovod_tpu_torch.utils.logging import get_logger

logger = get_logger("horovod_tpu_torch.elastic.resize")


class _Left:
    """What :meth:`ResizeCoordinator.resize` returns to a rank that left."""

    def __repr__(self):
        return "LEFT"


LEFT = _Left()


# ---------------------------------------------------------------------------
# plan: the one record every reshard participant keys off
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResizePlan:
    """One committed world change.

    ``carried`` maps every surviving old rank to its new rank. ``dead_ranks``
    are old ranks whose per-rank state has no owner in the new world —
    their residual shards merge into successors."""

    step: int
    old_world: int
    new_world: int
    dead_ranks: Tuple[int, ...] = ()
    carried: Tuple[Tuple[int, int], ...] = ()
    direction: str = "shrink"            # shrink | grow
    old_dcn: int = 1
    new_dcn: int = 1
    notice: Optional[Dict[str, Any]] = None
    generation: int = 0

    def __post_init__(self):
        if not self.carried:
            object.__setattr__(
                self, "carried", default_carried(
                    self.old_world, self.new_world, self.dead_ranks))
        survivors = {o for o, _ in self.carried}
        if set(self.dead_ranks) & survivors:
            raise ValueError(
                f"dead_ranks {self.dead_ranks} overlap carried ranks")
        if len({n for _, n in self.carried}) != len(self.carried):
            raise ValueError("carried maps two old ranks to one new rank")

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["dead_ranks"] = list(self.dead_ranks)
        d["carried"] = [list(p) for p in self.carried]
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "ResizePlan":
        d = json.loads(raw)
        d["dead_ranks"] = tuple(int(r) for r in d.get("dead_ranks", ()))
        d["carried"] = tuple((int(o), int(n))
                             for o, n in d.get("carried", ()))
        return cls(**d)


def default_carried(old_world: int, new_world: int,
                    dead_ranks: Sequence[int] = ()
                    ) -> Tuple[Tuple[int, int], ...]:
    """The canonical survivor mapping: shrink compacts survivors in
    old-rank order onto 0..len-1; grow keeps old ranks as a prefix."""
    dead = set(int(r) for r in dead_ranks)
    survivors = [r for r in range(old_world) if r not in dead]
    if len(survivors) > new_world:
        raise ValueError(
            f"{len(survivors)} survivors do not fit new world {new_world}")
    return tuple((o, n) for n, o in enumerate(survivors))


def successor_map(old_world: int, dead_ranks: Sequence[int]
                  ) -> Dict[int, int]:
    """Dead rank -> surviving old rank that absorbs its residual shard:
    the smallest surviving rank greater than the dead rank, wrapping to
    the smallest surviving rank overall. A pure function of (old_world,
    dead_ranks): every rank computes the identical map."""
    dead = {int(r) for r in dead_ranks}
    survivors = sorted(r for r in range(old_world) if r not in dead)
    if not survivors:
        raise ValueError("cannot merge residuals: no surviving ranks")
    out: Dict[int, int] = {}
    for d in sorted(dead):
        above = [s for s in survivors if s > d]
        out[d] = above[0] if above else survivors[0]
    return out


# ---------------------------------------------------------------------------
# EF-residual re-partitioning (sum-into-successor; bitwise-deterministic)
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists, tuples and
    namedtuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _repartition_leaf(x: Any, old_world: int, new_world: int,
                      carried: Sequence[Tuple[int, int]],
                      succ: Dict[int, int]) -> Any:
    """One leaf shaped ``(old_world, *shape)`` (numpy array or tensor)
    onto ``(new_world, *shape)``: survivors' rows at their new ranks,
    each dead row added to its successor's, ascending."""
    is_tensor = torch.is_tensor(x)
    if not is_tensor:
        x = np.asarray(x)
    if x.ndim < 1 or x.shape[0] != old_world:
        raise ValueError(
            f"residual leaf has shape {tuple(x.shape)}; expected a leading "
            f"world dim of {old_world} (per-rank state)")
    if is_tensor:
        out = torch.zeros((new_world,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
    else:
        out = np.zeros((new_world,) + x.shape[1:], dtype=x.dtype)
    new_of_old = dict(carried)
    for o, n in carried:
        out[n] = x[o]
    for d in sorted(succ):
        out[new_of_old[succ[d]]] += x[d]
    return out


def repartition_residual(tree: Any, old_world: int, new_world: int,
                         dead_ranks: Sequence[int] = (),
                         carried: Optional[Sequence[Tuple[int, int]]] = None
                         ) -> Any:
    """Re-partition per-rank error-feedback state (leaves shaped
    ``(old_world, *shape)``, numpy arrays or tensors) onto a resized world.

    Survivors keep their own shards at their new ranks; each dead rank's
    shard is ADDED to its successor's (ascending dead-rank order —
    deterministic and bitwise-stable across ranks and runs); new ranks
    enter with zero shards. The tree SUM is invariant under a shrink.
    Returns leaves of the same type and dtype."""
    dead = tuple(int(r) for r in dead_ranks)
    if carried is None:
        carried = default_carried(old_world, new_world, dead)
    carried = tuple((int(o), int(n)) for o, n in carried)
    succ = successor_map(old_world, dead) if dead else {}
    return _map(lambda x: _repartition_leaf(x, old_world, new_world,
                                            carried, succ), tree)


def reshard_wire_state(state: Any, plan: ResizePlan) -> Any:
    """Apply :func:`repartition_residual` to every leaf under a field or
    key named ``residual`` (``WireState``/``DistributedApplyState``'s
    per-rank field) whose leading dim is the old world, leaving everything
    else untouched."""

    def walk(node, under):
        if isinstance(node, dict):
            return {k: walk(v, under or k == "residual")
                    for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(walk(v, under or f == "residual")
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, under) for v in node)
        if under and hasattr(node, "shape") and len(node.shape) >= 1 \
                and node.shape[0] == plan.old_world:
            return repartition_residual(
                node, plan.old_world, plan.new_world, plan.dead_ranks,
                plan.carried)
        return node

    return walk(state, False)


# ---------------------------------------------------------------------------
# sampler carryover (the TorchState.sync merge, factored + wired)
# ---------------------------------------------------------------------------

def merge_sampler_states(snaps: Sequence[Dict[str, Any]]
                         ) -> Dict[str, Any]:
    """Union every rank's per-rank ``processed_indices`` and adopt the
    max epoch — the exact merge ``TorchState.sync`` performs before its
    broadcast: no processed sample reappears, none is skipped."""
    merged: set = set()
    for s in snaps:
        merged.update(int(i) for i in s["processed_indices"])
    return {"epoch": max(int(s["epoch"]) for s in snaps) if snaps else 0,
            "processed_indices": sorted(merged)}


# ---------------------------------------------------------------------------
# ResizeableState registry
# ---------------------------------------------------------------------------

class ResizeableState:
    """Contract for state that must survive a live resize. ``gather(plan)``
    runs on EVERY rank of the old world, while it still stands (the only
    moment a leaving rank's state can be collected); ``reshard(plan)``
    runs on the survivors after the new world is up and before training
    resumes. Implementations must be idempotent per plan."""

    def gather(self, plan: ResizePlan) -> None:
        pass

    def reshard(self, plan: ResizePlan) -> None:
        raise NotImplementedError


_participants: "OrderedDict[str, ResizeableState]" = OrderedDict()


def register_resizeable(name: str, participant: ResizeableState) -> None:
    """Register a reshard participant (registration order = reshard
    order). Re-registering a name replaces the participant in place."""
    replaced = name in _participants
    _participants[name] = participant
    if replaced:
        logger.warning("resizeable participant %r replaced", name)


def unregister_resizeable(name: str) -> None:
    _participants.pop(name, None)


def resizeable_participants() -> Dict[str, ResizeableState]:
    return dict(_participants)


def _world() -> Tuple[int, int]:
    import horovod_tpu_torch as htt
    if htt.is_initialized():
        return htt.rank(), htt.size()
    return 0, 1


class SamplerCarryover(ResizeableState):
    """ElasticSampler carryover across a resize: merges every rank's
    processed set (:func:`merge_sampler_states`) and rebuilds the samplers
    over the new world. ``replicas_fn`` maps the plan to the new shard
    count (default: the new world). In a world of several ranks each rank
    holds its own sampler(s): ``gather`` collects every rank's processed
    set over the old world, and ``reshard`` rebuilds this rank's sampler
    at its new rank. In a world of one (the JAX package's single
    controller) ``samplers`` is every shard and all are rebuilt."""

    def __init__(self, samplers: Sequence[Any],
                 replicas_fn: Optional[Callable[[ResizePlan], int]] = None):
        self.samplers: List[Any] = list(samplers)
        self._replicas_fn = replicas_fn or (lambda plan: plan.new_world)
        self._merged: Optional[Dict[str, Any]] = None

    def state_dicts(self) -> List[Dict[str, Any]]:
        return [s.state_dict() for s in self.samplers]

    def gather(self, plan: ResizePlan) -> None:
        _, world = _world()
        snaps = self.state_dicts()
        if world > 1:
            from horovod_tpu_torch.functions import allgather_object
            snaps = [s for rank_snaps in allgather_object(snaps)
                     for s in rank_snaps]
        self._merged = merge_sampler_states(snaps)

    def reshard(self, plan: ResizePlan) -> None:
        from horovod_tpu_torch.elastic.sampler import ElasticSampler
        if not self.samplers:
            return
        merged = self._merged or merge_sampler_states(self.state_dicts())
        self._merged = None
        proto = self.samplers[0]
        n = int(self._replicas_fn(plan))
        rank, world = _world()
        ranks = [rank] if world > 1 else range(n)
        rebuilt = []
        for r in ranks:
            s = ElasticSampler(proto.dataset_size, shuffle=proto.shuffle,
                               seed=proto.seed, rank=r, num_replicas=n)
            s.load_state_dict(merged)
            rebuilt.append(s)
        self.samplers = rebuilt


# ---------------------------------------------------------------------------
# plan commit: atomic, AFTER the snapshot
# ---------------------------------------------------------------------------

def plan_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"resize-step-{int(step):08d}.json")


def commit_plan(directory: str, plan: ResizePlan) -> str:
    """Durably publish ``plan`` next to the checkpoint directory: the full
    payload into a ``.part`` sibling, ONE ``schedhooks.rename`` publishes.
    Called only after the stop-step snapshot is committed — a committed
    plan is a promise that its snapshot exists."""
    os.makedirs(directory, exist_ok=True)
    path = plan_path(directory, plan.step)
    part = path + ".part"
    with open(part, "w") as f:
        f.write(plan.to_json())
        f.flush()
        os.fsync(f.fileno())
    schedhooks.rename(part, path)
    return path


def load_plan(directory: str, step: Optional[int] = None
              ) -> Optional[ResizePlan]:
    """The committed plan for ``step`` (or the newest one), or None.
    ``.part`` leftovers are never read."""
    if not os.path.isdir(directory):
        return None
    if step is not None:
        path = plan_path(directory, step)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return ResizePlan.from_json(f.read())
    best: Optional[str] = None
    for name in sorted(os.listdir(directory)):
        if name.startswith("resize-step-") and name.endswith(".json"):
            best = name
    if best is None:
        return None
    with open(os.path.join(directory, best)) as f:
        return ResizePlan.from_json(f.read())


def adopt_plan_on_restore(directory: str, state: Any,
                          step: Optional[int] = None) -> Any:
    """Apply the committed plan's residual merge to a state whose residual
    leaves are world-stacked (``(old_world, ...)``, the JAX package's
    layout). No plan on disk = state returned untouched. A world of
    processes restores through :func:`restore_resized`."""
    plan = load_plan(directory, step)
    if plan is None:
        return state
    return reshard_wire_state(state, plan)


# -- the per-rank leaves of a host snapshot and of a live state -----------

def _host_per_rank(host: Any, out: List[Any]) -> None:
    """Append the leaves under every ``PerRank`` node of a checkpoint's
    host tree, in walk order."""
    from horovod_tpu_torch.resilience import async_checkpoint as ac
    if isinstance(host, ac.PerRank):
        out.extend(ac._leaves(host.value))
    elif isinstance(host, (ac.ModuleImage, ac.OptimizerImage)):
        for f in dataclasses.fields(host):
            _host_per_rank(getattr(host, f.name), out)
    elif isinstance(host, dict):
        for v in host.values():
            _host_per_rank(v, out)
    elif isinstance(host, (list, tuple)):
        for v in host:
            _host_per_rank(v, out)


def _rebuild_leaves(node: Any, it) -> Any:
    from horovod_tpu_torch.resilience import async_checkpoint as ac
    if isinstance(node, dict):
        return {k: _rebuild_leaves(v, it) for k, v in node.items()}
    if _is_namedtuple(node):
        return type(node)(*(_rebuild_leaves(v, it) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild_leaves(v, it) for v in node)
    if isinstance(node, (ac.ModuleImage, ac.OptimizerImage, ac.PerRank)):
        raise TypeError("a per-rank subtree holds an image")
    return next(it)


def _host_replace_per_rank(host: Any, it) -> Any:
    from horovod_tpu_torch.resilience import async_checkpoint as ac
    if isinstance(host, ac.PerRank):
        return ac.PerRank(_rebuild_leaves(host.value, it))
    if isinstance(host, (ac.ModuleImage, ac.OptimizerImage)):
        return type(host)(*(_host_replace_per_rank(getattr(host, f.name),
                                                   it)
                            for f in dataclasses.fields(host)))
    if _is_namedtuple(host):
        return type(host)(*(_host_replace_per_rank(v, it) for v in host))
    if isinstance(host, dict):
        return {k: _host_replace_per_rank(v, it) for k, v in host.items()}
    if isinstance(host, (list, tuple)):
        return type(host)(_host_replace_per_rank(v, it) for v in host)
    return host


def live_per_rank_tensors(state: Any) -> List[torch.Tensor]:
    """The per-rank tensors of a live training state, in the order the
    checkpoint writes them: every tensor under a namedtuple field named
    in its type's ``_per_rank_fields`` (the error-feedback residual of
    ``DistributedApplyState``/``WireState``) and the ``wire_state``
    residuals of a ``DistributedOptimizer``."""
    from horovod_tpu_torch.parallel.distributed import DistributedOptimizer
    out: List[torch.Tensor] = []

    def tensors(node):
        if torch.is_tensor(node):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                tensors(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                tensors(v)

    def walk(node):
        if isinstance(node, DistributedOptimizer):
            if node.wire_state:
                tensors(list(node.wire_state.residual))
        elif _is_namedtuple(node):
            ranked = getattr(type(node), "_per_rank_fields", ())
            for f, v in zip(node._fields, node):
                (tensors if f in ranked else walk)(v)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(state)
    return out


def restore_resized(directory: str, template: Any,
                    step: Optional[int] = None) -> Tuple[int, Any]:
    """Cold start of a resized world: restore the stop-step snapshot of
    the committed plan (``step``, or the newest plan) into the live
    ``template`` on this rank of the NEW world, applying the plan's
    residual merge — bitwise the state the live resize left on this rank.
    Replicated leaves come from shard 0; this rank's per-rank leaves are
    the merge over every old rank's shard (a new rank of a grow gets
    zeros). Returns ``(step, state)``."""
    from horovod_tpu_torch.resilience import async_checkpoint as ac
    plan = load_plan(directory, step)
    if plan is None:
        raise FileNotFoundError(f"no committed resize plan in {directory}")
    ckpt_dir = os.path.join(directory, ac.step_dirname(plan.step))
    if ac.read_manifest(ckpt_dir) is None:
        raise FileNotFoundError(
            f"the plan of step {plan.step} has no committed snapshot in "
            f"{directory}")
    rank, world = schedhooks.process_world()
    if world != plan.new_world:
        raise ValueError(f"the plan resizes to {plan.new_world} ranks; "
                         f"this world has {world}")

    def shard(r):
        return ac._read_shard(os.path.join(ckpt_dir, f"shard-{r:05d}.pkl"))

    rank0 = shard(0)
    old_of_new = {n: o for o, n in plan.carried}
    mine = old_of_new.get(rank)
    host = rank0 if mine in (None, 0) else ac._merge_rank0(shard(mine),
                                                           rank0)
    rows: List[List[Any]] = []
    for o in range(plan.old_world):
        leaves: List[Any] = []
        _host_per_rank(rank0 if o == 0 else shard(o), leaves)
        rows.append(leaves)
    merged = []
    for i in range(len(rows[0])):
        stacked = torch.stack([torch.as_tensor(np.asarray(r[i]))
                               if not torch.is_tensor(r[i]) else r[i]
                               for r in rows])
        merged.append(repartition_residual(
            stacked, plan.old_world, plan.new_world, plan.dead_ranks,
            plan.carried)[rank])
    host = _host_replace_per_rank(host, iter(merged))
    return plan.step, ac._place_tree(host, template)


# ---------------------------------------------------------------------------
# the write-once resize agreement (stop-step protocol reused)
# ---------------------------------------------------------------------------

class ResizeAgreement:
    """Cross-rank agreement on ONE resize plan: the first rank armed with
    a notice publishes ``{stop_step, notice}`` write-once under a
    per-generation store key; every rank polls from ``check()`` and
    quiesces at the published step. Transport failures abandon the
    attempt on this rank (training continues on the old world; the
    proposal retries at the next ``check``) — only an adopted PUBLISHED
    plan ever quiesces, so two ranks never act on different plans."""

    def __init__(self, generation: int = 0, margin: Optional[int] = None,
                 timeout: Optional[float] = None):
        self.generation = int(generation)
        self.margin = int(knobs.get("HOROVOD_ELASTIC_RESIZE_MARGIN")
                          if margin is None else margin)
        self.timeout = float(knobs.get("HOROVOD_ELASTIC_RESIZE_TIMEOUT")
                             if timeout is None else timeout)
        self._notice: Optional[Dict[str, Any]] = None
        self._adopted: Optional[Dict[str, Any]] = None
        self._published = False
        self._last_poll = 0.0

    @property
    def key(self) -> str:
        return f"hvd_resize/g{self.generation}/plan"

    def _kv(self):
        from horovod_tpu_torch.utils.kvstore import distributed_kv
        return distributed_kv(site="resize")

    @property
    def armed(self) -> bool:
        return self._notice is not None or self._adopted is not None

    @property
    def adopted(self) -> Optional[Dict[str, Any]]:
        return self._adopted

    def propose(self, notice: Dict[str, Any]) -> None:
        """Arm this rank with a world-change notice; the plan publishes at
        the next ``check()``."""
        if self._notice is None and self._adopted is None:
            self._notice = dict(notice)

    def check(self, step: int) -> Optional[Dict[str, Any]]:
        """Once per training step. Returns the agreed proposal when
        ``step`` is the quiesce step (quiesce NOW), else None."""
        kv = self._kv()
        if self._adopted is None and self._notice is not None \
                and not self._published:
            proposal = {"stop_step": int(step) + self.margin,
                        "notice": self._notice}
            if kv is None:
                self._adopted = proposal            # a world of one
                self._published = True
            else:
                try:
                    try:
                        kv.set(self.key, json.dumps(proposal,
                                                    sort_keys=True))
                    except Exception:
                        pass         # a peer won the write-once race
                    raw = kv.get(self.key, timeout_s=self.timeout)
                    self._adopted = json.loads(raw)
                    self._published = True
                except Exception:
                    logger.warning(
                        "resize agreement unavailable at step %d; "
                        "continuing on the old world (will retry)", step)
                    return None
        elif self._adopted is None and kv is not None:
            # throttled to the preemption-handler cadence: the margin must
            # cover poll_seconds/step_time steps of adoption skew
            now = time.monotonic()
            if now - self._last_poll < max(
                    float(knobs.get("HOROVOD_PREEMPTION_POLL_SECONDS")),
                    0.0):
                return None
            self._last_poll = now
            try:
                raw = kv.try_get(self.key)
            except Exception:
                raw = None
            if raw is not None:
                self._adopted = json.loads(raw)
                self._published = True
        if self._adopted is None:
            return None
        stop = int(self._adopted["stop_step"])
        if step >= stop:
            if step > stop:
                logger.warning(
                    "resize stop step %d already passed (at %d); "
                    "quiescing now", stop, step)
            return self._adopted
        return None

    def ack_key(self, pidx: int) -> str:
        return f"hvd_resize/g{self.generation}/ack/{pidx}"


def commit_plan_after_snapshot(directory: str, plan: ResizePlan,
                               kv: Any = None, pidx: int = 0,
                               nproc: int = 1,
                               timeout: Optional[float] = None) -> bool:
    """The plan-commit barrier: every rank calls this AFTER its stop-step
    snapshot is durable. Followers ack; the leader waits for every ack,
    commits the plan atomically, and publishes the commit record. Returns
    True when the plan committed (a world of one: immediately). A timeout
    abandons the attempt UNCOMMITTED."""
    timeout = float(knobs.get("HOROVOD_ELASTIC_RESIZE_TIMEOUT")
                    if timeout is None else timeout)
    gen = plan.generation
    if kv is None or nproc <= 1:
        commit_plan(directory, plan)
        return True
    ack = f"hvd_resize/g{gen}/ack/{pidx}"
    committed_key = f"hvd_resize/g{gen}/committed"
    if pidx != 0:
        try:
            kv.set(ack, "ok")
        except Exception:
            pass                     # leader times out -> attempt abandoned
        try:
            kv.get(committed_key, timeout_s=timeout)
            return True
        except Exception:
            # The commit record is ADVISORY — the plan rename IS the
            # commit: consult the shared plan file before giving up.
            return load_plan(directory, plan.step) is not None
    try:
        for p in range(1, nproc):
            kv.get(f"hvd_resize/g{gen}/ack/{p}", timeout_s=timeout)
    except Exception:
        logger.warning("resize plan abandoned: snapshot ack barrier "
                       "timed out (generation %d)", gen)
        return False
    commit_plan(directory, plan)
    try:
        kv.set(committed_key, "1")
    except Exception:
        pass                         # advisory; the rename IS the commit
    return True


# ---------------------------------------------------------------------------
# resize metrics (the topology gauges are metrics.publish_topology_gauges)
# ---------------------------------------------------------------------------

_last_resize: Optional[Dict[str, Any]] = None


def last_resize_info() -> Optional[Dict[str, Any]]:
    """The last committed resize (direction/worlds/step/duration), or
    None."""
    return _last_resize


def _record_resize(plan: ResizePlan, seconds: float) -> None:
    global _last_resize
    from horovod_tpu_torch import metrics as M
    M.counter("hvd_elastic_resizes_total",
              "Live world resizes committed in-process",
              labelnames=("direction",)).labels(
                  direction=plan.direction).inc()
    M.histogram("hvd_elastic_resize_seconds",
                "Wall time of one quiesce->snapshot->rebuild->reshard "
                "resize commit").observe(seconds)
    _last_resize = {
        "direction": plan.direction,
        "from_world": plan.old_world,
        "to_world": plan.new_world,
        "step": plan.step,
        "dead_ranks": list(plan.dead_ranks),
        "seconds": round(float(seconds), 4),
    }
    M.publish_topology_gauges()


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------

def _launcher_store() -> bool:
    """True when the launcher hosts the c10d store (every rank a client)."""
    return os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"


class ResizeCoordinator:
    """Drives a running loop through live resizes. Typical wiring::

        rc = elastic.ResizeCoordinator(checkpointer=ckpt, host_size=2)
        for step in ...:
            rc.poll(step)                       # chaos / agent notices
            if rc.check(step):                  # quiesce step reached
                state = rc.resize(step, state)  # N -> N-k, in process
                if state is resize.LEFT:        # this rank's host left
                    break
            ...train on the (possibly new) world...

    ``host_size`` is the host granularity over the ranks of the world at
    construction: host ``h`` owns ranks ``[h*host_size, (h+1)*host_size)``
    of that ORIGINAL world (default ``LOCAL_WORLD_SIZE``, else this host's
    rank count). Slice granularity comes from the initial topology's DCN
    tier."""

    def __init__(self, checkpointer: Optional[Any] = None,
                 host_size: Optional[int] = None,
                 margin: Optional[int] = None,
                 timeout: Optional[float] = None):
        import horovod_tpu_torch as htt
        from horovod_tpu_torch.runtime.context import get_context
        if not htt.is_initialized():
            raise RuntimeError("ResizeCoordinator needs an initialized "
                               "runtime (init() first)")
        ctx = get_context()
        self.checkpointer = checkpointer
        # every rank of the original world, by its original rank: host
        # and slice blocks are defined over THIS list for the life of the
        # coordinator; _alive is the current world in rank order
        self._universe: List[int] = list(range(ctx.size))
        self._alive: List[int] = list(self._universe)
        self._me = ctx.rank
        self._host_size = int(host_size
                              or int(os.environ.get("LOCAL_WORLD_SIZE", 0))
                              or max(ctx.local_size, 1))
        self._orig_dcn = ctx.topology.dcn_size
        self._dead_hosts: set = set()
        self._dead_slices: set = set()
        self._margin = margin
        self._timeout = timeout
        self._generation = 0
        self.agreement = ResizeAgreement(0, margin, timeout)
        self.resizes_committed = 0

    # -- world bookkeeping ---------------------------------------------------
    def _host_block(self, h: int) -> List[int]:
        hs = self._host_size
        block = self._universe[h * hs:(h + 1) * hs]
        if not block:
            raise ValueError(f"host {h} has no ranks (host_size={hs}, "
                             f"world {len(self._universe)})")
        return block

    def _slice_block(self, s: int) -> List[int]:
        if self._orig_dcn <= 1:
            raise ValueError("slice_loss notice on a single-slice world")
        per = len(self._universe) // self._orig_dcn
        return self._universe[s * per:(s + 1) * per]

    def _dead_members(self, dead_hosts=None, dead_slices=None) -> set:
        dead: set = set()
        for h in (self._dead_hosts if dead_hosts is None else dead_hosts):
            dead.update(self._host_block(h))
        for s in (self._dead_slices if dead_slices is None
                  else dead_slices):
            dead.update(self._slice_block(s))
        return dead

    def alive_ranks(self, dead_hosts=None, dead_slices=None) -> List[int]:
        """The original ranks of the world the notices leave (all of them
        by default: the current world)."""
        dead = self._dead_members(dead_hosts, dead_slices)
        return [d for d in self._universe if d not in dead]

    def _alive_slices(self, dead_slices=None) -> int:
        if self._orig_dcn <= 1:
            return 1
        return self._orig_dcn - len(
            self._dead_slices if dead_slices is None else dead_slices)

    # -- notices -------------------------------------------------------------
    def poll(self, step: int) -> None:
        """Consult the chaos hook (and any agent feeding it) for a pending
        world-change notice at ``step``."""
        from horovod_tpu_torch.resilience import chaos
        notice = chaos.resize_notice(step)
        if notice is not None:
            self.notice(notice)

    def notice(self, notice: Dict[str, Any]) -> None:
        """Deliver a world-change notice programmatically:
        ``{"kind": "host_loss"|"host_return", "host": h}`` or
        ``{"kind": "slice_loss", "slice": s}``."""
        self.agreement.propose(notice)

    # -- quiesce + execute ---------------------------------------------------
    def check(self, step: int) -> bool:
        """Once per training step: True when this is the agreed quiesce
        step — call :meth:`resize` now."""
        return self.agreement.check(step) is not None

    def _notice_effect(self, notice: Dict[str, Any]) -> Tuple[set, set]:
        """The (dead_hosts, dead_slices) the notice WOULD leave; adopted
        only once the resize commits."""
        hosts, slices = set(self._dead_hosts), set(self._dead_slices)
        kind = notice.get("kind")
        if kind == "host_loss":
            hosts.add(int(notice["host"]))
        elif kind == "slice_loss":
            slices.add(int(notice["slice"]))
        elif kind == "host_return":
            hosts.discard(int(notice["host"]))
        else:
            raise ValueError(f"unknown resize notice kind {kind!r}")
        return hosts, slices

    def _build_plan(self, step: int, old: List[int], new: List[int],
                    notice: Dict[str, Any], old_dcn: int,
                    new_dcn: int) -> ResizePlan:
        new_rank = {m: i for i, m in enumerate(new)}
        carried = tuple((o, new_rank[m]) for o, m in enumerate(old)
                        if m in new_rank)
        dead = tuple(o for o, m in enumerate(old) if m not in new_rank)
        direction = "shrink" if len(new) < len(old) else "grow"
        return ResizePlan(
            step=int(step), old_world=len(old), new_world=len(new),
            dead_ranks=dead, carried=carried, direction=direction,
            old_dcn=int(old_dcn), new_dcn=int(new_dcn),
            notice=dict(notice), generation=self._generation)

    def resize(self, step: int, state: Any = None) -> Any:
        """Execute the agreed resize at the quiesce step (see the module
        docstring): drain eager handles, commit the final snapshot + plan,
        gather the per-rank state, let the lost ranks go, rebuild the
        world on the survivors and reshard. Returns ``state`` with its
        per-rank residual re-partitioned in place on a survivor, and
        :data:`LEFT` on a rank that left."""
        import torch.distributed as dist

        import horovod_tpu_torch as htt
        from horovod_tpu_torch import eager
        from horovod_tpu_torch.elastic.exceptions import (
            HostsUpdatedInterrupt)
        from horovod_tpu_torch.ops import collectives
        from horovod_tpu_torch.runtime import context
        adopted = self.agreement.adopted
        if adopted is None:
            raise RuntimeError("resize() called with no agreed plan; "
                               "gate on check(step) first")
        notice = adopted["notice"]
        t0 = time.perf_counter()
        ctx = context.get_context()
        old_dcn = ctx.topology.dcn_size
        dead_hosts, dead_slices = self._notice_effect(notice)
        new_members = self.alive_ranks(dead_hosts, dead_slices)
        if not new_members:
            raise RuntimeError("resize would leave zero ranks")
        new_dcn = self._alive_slices(dead_slices)
        plan = self._build_plan(step, self._alive, new_members, notice,
                                old_dcn, new_dcn)
        my_old = ctx.rank
        if plan.direction == "shrink" and 0 in plan.dead_ranks \
                and not _launcher_store():
            raise RuntimeError(
                "this resize removes rank 0's host, and rank 0 hosts the "
                "c10d store of an env:// world: the survivors would lose "
                "it. Run under hvdrun-torch (it hosts the store; "
                "TORCHELASTIC_USE_AGENT_STORE=True) or keep rank 0's host")

        # (2) outstanding eager handles resolve NOW, with the reason; the
        # old coordinator's tuner trajectory is archived under its world
        # key, so a grow-back to that world resumes it
        eager.reset_outstanding(ResizeInterrupt(
            f"world resize at step {step}: "
            f"{plan.old_world} -> {plan.new_world}"))
        if ctx.coordinator is not None:
            ctx.coordinator.autotune.archive_world_history()

        # (3) final synchronous snapshot, then the plan — strictly after
        if self.checkpointer is not None and state is not None:
            self.checkpointer.save(step, state, sync=True)
            pidx, nproc = self.checkpointer._world()
            kv = None
            if nproc > 1:
                from horovod_tpu_torch.utils.kvstore import distributed_kv
                kv = distributed_kv(site="resize")
            if not commit_plan_after_snapshot(
                    self.checkpointer.directory, plan, kv=kv, pidx=pidx,
                    nproc=nproc, timeout=self._timeout):
                logger.warning("resize abandoned at step %d (plan "
                               "barrier); continuing on the old world "
                               "and retrying the agreement", step)
                self._rearm()
                self.agreement.propose(notice)
                return state
        if plan.direction == "grow":
            # the returning ranks are processes this world does not have:
            # the respawn (exit 73 under elastic.run) starts the larger
            # world, which restores through restore_resized
            self._rearm()
            raise HostsUpdatedInterrupt(skip_sync=False)

        # (4) gather every rank's per-rank state on the old world
        tensors = live_per_rank_tensors(state) if state is not None else []
        my_new = dict(plan.carried).get(my_old)
        for t in tensors:
            stacked = collectives.allgather(t.detach().unsqueeze(0))
            merged = repartition_residual(
                stacked, plan.old_world, plan.new_world, plan.dead_ranks,
                plan.carried)
            if my_new is not None:
                with torch.no_grad():
                    t.copy_(merged[my_new])
        for participant in list(_participants.values()):
            participant.gather(plan)
        if my_new is None:
            htt.shutdown()
            if dist.is_initialized():
                dist.destroy_process_group()
            logger.warning("rank %d left the world at step %d (resize "
                           "%d -> %d)", my_old, step, plan.old_world,
                           plan.new_world)
            return LEFT

        # the resize is committed from here on: adopt the bookkeeping
        self._dead_hosts, self._dead_slices = dead_hosts, dead_slices
        self._alive = new_members

        # (5) rebuild the world on the survivors over the old store
        if knobs.get("HOROVOD_DCN_VIRTUAL_SLICES"):
            knobs.set_override("HOROVOD_DCN_VIRTUAL_SLICES", 0)
        if knobs.get("HOROVOD_DCN_MESH"):
            logger.warning("HOROVOD_DCN_MESH describes the pre-resize "
                           "world; overriding to empty for the rebuild")
            knobs.set_override("HOROVOD_DCN_MESH", "")
        if knobs.get("HOROVOD_TPU_MESH_SHAPE"):
            knobs.set_override("HOROVOD_TPU_MESH_SHAPE", "")
        device, backend = ctx.device, ctx.backend
        store = dist.distributed_c10d._get_default_store()
        htt.shutdown()
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group(
            backend, store=dist.PrefixStore(
                f"hvd/resize/{plan.generation}", store),
            rank=my_new, world_size=plan.new_world)
        new_ctx = context.init(device=device,
                               dcn=new_dcn if new_dcn > 1 else None)
        new_ctx.owns_group = True
        if self.checkpointer is not None:
            # its writer's store connection belongs to the old world
            self.checkpointer._commit_kv = None

        # (6) reshard the participants; the commit point
        for name, participant in list(_participants.items()):
            try:
                participant.reshard(plan)
            except Exception:
                logger.exception("resizeable participant %r failed to "
                                 "reshard; state may be stale", name)
                raise
        self.resizes_committed += 1
        self._rearm()
        _record_resize(plan, time.perf_counter() - t0)
        logger.warning(
            "world resized at step %d: %d -> %d ranks (%s, dcn %d -> %d, "
            "dead ranks %s)", step, plan.old_world, plan.new_world,
            plan.direction, plan.old_dcn, plan.new_dcn,
            list(plan.dead_ranks))
        return state

    def _rearm(self) -> None:
        """A fresh agreement (new store generation) for the next notice."""
        self._generation += 1
        self.agreement = ResizeAgreement(self._generation, self._margin,
                                         self._timeout)

    # -- convenience ---------------------------------------------------------
    def maybe_resize(self, step: int, state: Any = None
                     ) -> Tuple[bool, Any]:
        """poll + check + resize in one call: returns ``(resized,
        state)``."""
        self.poll(step)
        if self.check(step):
            return True, self.resize(step, state)
        return False, state
