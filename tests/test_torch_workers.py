"""Worker processes of the port's multi-process tests (no tests here).

``run_world`` starts one process per rank with ``torch.multiprocessing``
(``spawn``), each joining a gloo world on localhost. The workers live in
this module, which imports neither jax nor the JAX package, so a spawned
rank starts in the time it takes to import torch. Each rank writes its
results to ``<out_dir>/rank<r>.npz``.
"""

import os
import socket

import numpy as np
import torch

import horovod_tpu_torch as htt
from horovod_tpu_torch.utils import tree as tree_util

TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_world(target, world: int, *args):
    """Start ``target(rank, world, port, *args)`` in ``world`` spawned
    processes; returns them (finish with :func:`join_world`)."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_world(procs) -> None:
    """Join the ranks within TIMEOUT_S in all; a rank that hangs is killed
    and fails the test, as does a non-zero exit."""
    for p in procs:
        p.join(timeout=TIMEOUT_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(timeout=10)
    assert not alive, f"{len(alive)} rank(s) hung"
    assert [p.exitcode for p in procs] == [0] * len(procs)


def _join_gloo(rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    htt.init(device="cpu")
    assert htt.size() == world and htt.rank() == rank


def dp_worker(rank, world, port, cfg, np_params, batches, out_dir):
    """Trains ``cfg`` from ``np_params`` on this rank's rows of each global
    batch with SGD(0.01, momentum=0.9). Rank r starts from the weights
    times (1 + r): ``init_fn`` must broadcast rank 0's."""
    _join_gloo(rank, world, port)
    try:
        init_fn, step = htt.make_transformer_train_step(
            cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
            device="cpu")
        scaled = tree_util.tree_map(lambda a: a * (1 + rank), np_params)
        state = init_fn(htt.params_from_numpy(scaled, device="cpu"))
        b = batches[0][0].shape[0]
        rows = slice(rank * b // world, (rank + 1) * b // world)
        losses = []
        for tokens, labels in batches:
            state, loss = step(state, tokens[rows], labels[rows])
            losses.append(float(loss))
        leaves = [t.detach().numpy()
                  for t in tree_util.tree_leaves(state.params)]
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 *leaves, losses=np.asarray(losses))
    finally:
        htt.shutdown()


def resnet_dp_worker(rank, world, port, model_kw, np_vars, batches, out_dir):
    """Trains ``ResNet(**model_kw, bn_cross_replica_axis="hvd")`` from the
    flax variables ``np_vars`` on this rank's rows of each global batch
    with ``data_parallel_train_step(bind_axis=True)`` and a
    ``DistributedOptimizer`` (SGD 0.01, momentum 0.9). Rank r starts from
    the variables times (1 + r): ``init_fn`` must broadcast rank 0's
    parameters and running statistics. Saves the losses and the final
    variables as ``<collection>|<path>`` entries."""
    import torch.nn.functional as F
    from horovod_tpu_torch.models import resnet
    _join_gloo(rank, world, port)
    try:
        model = resnet.ResNet(**model_kw, bn_cross_replica_axis="hvd",
                              device="cpu")
        resnet.variables_from_numpy(model, tree_util.tree_map(
            lambda a: a * (1 + rank), np_vars))
        opt = htt.DistributedOptimizer(torch.optim.SGD(
            model.parameters(), lr=0.01, momentum=0.9))
        init_fn, step, put_batch = htt.data_parallel_train_step(
            lambda m, x, y: F.cross_entropy(m(x, train=True), y), opt,
            device="cpu", axis="hvd", bind_axis=True)
        state = init_fn(model)
        losses = []
        for batch in batches:
            state, loss = step(state, *put_batch(batch))
            losses.append(float(loss))
        out = {"losses": np.asarray(losses)}
        for coll, tree in resnet.variables_to_numpy(model).items():
            for path, leaf in tree_util.flatten_dict(tree).items():
                out["|".join((coll,) + path)] = leaf
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        htt.shutdown()


def collectives_worker(rank, world, port, out_dir):
    """Every collective of the port on rank-dependent inputs: rank r holds
    ``x[r]`` of the rank-stacked arrays the parent rebuilds with
    :func:`collective_inputs`."""
    _join_gloo(rank, world, port)
    try:
        x, ints, mixed = collective_inputs(world)
        out = {}
        for op in ("Sum", "Average", "Min", "Max", "Product"):
            t = torch.from_numpy(x[rank].copy())
            out[op] = htt.allreduce(t, getattr(htt, op)).numpy()
            out[op + "_scaled"] = htt.allreduce(
                t, getattr(htt, op), prescale_factor=0.5,
                postscale_factor=3.0).numpy()
            assert np.array_equal(t.numpy(), x[rank]), "input changed"
        out["int_sum"] = htt.allreduce(torch.from_numpy(ints[rank].copy()),
                                       htt.Sum).numpy()
        out["int_average"] = htt.allreduce(
            torch.from_numpy(ints[rank].copy()), htt.Average).numpy()
        grouped = htt.grouped_allreduce(
            [torch.from_numpy(a[rank].copy()) for a in mixed], htt.Sum)
        for i, g in enumerate(grouped):
            out[f"grouped_{i}"] = g.numpy()
        out["broadcast"] = htt.broadcast(
            torch.from_numpy(x[rank].copy()), root_rank=world - 1).numpy()
        htt.barrier()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        htt.shutdown()


def collective_inputs(world: int):
    """Rank-stacked inputs of :func:`collectives_worker` (seeded)."""
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((world, 3, 5)) + 2.0).astype(np.float32)
    ints = rng.integers(-50, 50, (world, 7)).astype(np.int32)
    mixed = [rng.standard_normal((world, 4)).astype(np.float32),
             rng.standard_normal((world, 2, 3)).astype(np.float64),
             rng.standard_normal((world, 6)).astype(np.float32),
             rng.integers(0, 9, (world, 5)).astype(np.int64)]
    return x, ints, mixed


# ---------------------------------------------------------------------------
# the bucketed gradient sync (tests/test_torch_grad_sync.py)
# ---------------------------------------------------------------------------

def _quadratic_loss(ps, x):
    """sum over leaves of sum(v * v), times sum(x): the JAX wire tests'
    loss (tests/test_wire_compression.py), on this rank's rows of x."""
    return sum((p * p).sum() for p in ps) * torch.from_numpy(x).sum()


def _scenario_optimizer(rank, sc):
    """DistributedOptimizer(SGD) over the leaves of ``sc["params"]`` in
    sorted-key order, one step per global x of ``sc["xs"]`` (with
    ``passes`` backward passes per step, each on its own x)."""
    keys = sorted(sc["params"])
    ps = [torch.tensor(sc["params"][k], requires_grad=True) for k in keys]
    passes = sc.get("passes", 1)
    opt = htt.DistributedOptimizer(
        torch.optim.SGD(ps, lr=0.1, momentum=sc.get("momentum", 0.0)),
        op=htt.Average, backward_passes_per_step=passes)
    xs = sc["xs"]
    for t in range(0, len(xs), passes):
        for x in xs[t:t + passes]:
            _quadratic_loss(ps, x[rank:rank + 1]).backward()
        opt.step()
        opt.zero_grad()
    out = {f"param|{k}": p.detach().numpy() for k, p in zip(keys, ps)}
    if opt.wire_state:
        out.update({f"residual|{k}": r.numpy()
                    for k, r in zip(keys, opt.wire_state.residual)})
    out["n_buckets"] = np.asarray(len(opt.buckets))
    return out


def _scenario_epilogue(rank, sc):
    """distributed_apply(EpilogueSGD or EpilogueAdam, axis="hvd") on the
    quadratic, three steps of the same x."""
    from horovod_tpu_torch.parallel import distributed as D
    params = {k: torch.tensor(v) for k, v in sc["params"].items()}
    kind, kw = sc["opt"]
    epi = (D.EpilogueAdam if kind == "adam" else D.EpilogueSGD)(**kw)
    da = htt.distributed_apply(epi, axis="hvd")
    state = da.init(params)
    x = sc["x"][rank:rank + 1]
    for _ in range(sc["steps"]):
        leaves = [params[k].requires_grad_(True) for k in sorted(params)]
        grads = torch.autograd.grad(_quadratic_loss(leaves, x), leaves)
        params, state = da.apply(
            params, dict(zip(sorted(params), grads)), state)
    return {f"param|{k}": v.detach().numpy() for k, v in params.items()}


def _scenario_fused(rank, sc):
    """make_transformer_train_step_fused with distributed_apply(
    EpilogueSGD(0.05, momentum=0.9), sync_axes=grad_sync_axes(cfg)) from
    ``sc["params"]``, one step per global batch on this rank's rows; rank
    r starts from the weights times (1 + r)."""
    from horovod_tpu_torch.models import transformer as tfm
    cfg = sc["cfg"]
    da = htt.distributed_apply(htt.EpilogueSGD(0.05, momentum=0.9),
                               sync_axes=tfm.grad_sync_axes(cfg))
    init_fn, step = htt.make_transformer_train_step_fused(cfg, da,
                                                          device="cpu")
    state = init_fn(htt.params_from_numpy(tree_util.tree_map(
        lambda a: a * (1 + rank), sc["params"]), device="cpu"))
    losses = []
    for tokens, labels in sc["batches"]:
        rows = slice(rank * tokens.shape[0] // 2,
                     (rank + 1) * tokens.shape[0] // 2)
        state, loss = step(state, tokens[rows], labels[rows])
        losses.append(float(loss))
    out = {"losses": np.asarray(losses)}
    flat = tree_util.flatten_dict(state.params)
    out.update({"param|" + "/".join(k): v.detach().numpy()
                for k, v in flat.items()})
    if state.opt_state.residual:
        flat = tree_util.flatten_dict(state.opt_state.residual)
        out.update({"residual|" + "/".join(k): v.numpy()
                    for k, v in flat.items()})
    return out


_SCENARIOS = {"optimizer": _scenario_optimizer,
              "epilogue": _scenario_epilogue, "fused": _scenario_fused}


def grad_sync_worker(rank, world, port, scenarios, out_dir):
    """Runs each scenario (a dict: ``name``, ``kind`` in _SCENARIOS,
    ``knobs`` to override while it runs, and its inputs) and saves its
    arrays as ``<out_dir>/<name>-rank<r>.npz``."""
    from horovod_tpu_torch.config import knobs
    _join_gloo(rank, world, port)
    try:
        for sc in scenarios:
            for k, v in sc.get("knobs", {}).items():
                knobs.set_override(k, v)
            try:
                out = _SCENARIOS[sc["kind"]](rank, sc)
            finally:
                for k in sc.get("knobs", {}):
                    knobs.clear_override(k)
            np.savez(os.path.join(out_dir, f"{sc['name']}-rank{rank}.npz"),
                     **out)
    finally:
        htt.shutdown()


# ---------------------------------------------------------------------------
# topology, collectives, process sets and the DCN tier
# (test_torch_topology, test_torch_collectives, test_torch_process_sets,
# test_torch_dcn_tier): one world runs phases, each an init with its own
# topology over a process group the worker made itself (so shutdown keeps
# it), and each phase runs scenarios
# ---------------------------------------------------------------------------

def _np_out(t):
    if torch.is_tensor(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def _rank_arg(a, rank, dtype=None):
    """Rank ``rank``'s part of a rank-stacked array (or a per-rank list)
    as a tensor, cast to ``dtype`` (a torch dtype name) when given."""
    t = torch.from_numpy(np.ascontiguousarray(a[rank]))
    return t.to(getattr(torch, dtype)) if dtype else t


def _call_scenario(rank, sc, sets):
    """One collective call: ``fn`` (a name in ops.collectives, or
    ``sparse_allreduce``) on this rank's parts of ``args``, with ``kw``,
    ``rank_kw`` (stacked per rank), ``ps`` (index into the phase's sets)
    and ``op``/``wire_codec`` by name. ``raises``: a NotImplementedError or
    ValueError is the result."""
    from horovod_tpu_torch.compression import WireCodec
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.ops import sparse
    from horovod_tpu_torch.ops.reduce_ops import ReduceOp
    fn = (sparse.sparse_allreduce if sc["fn"] == "sparse_allreduce"
          else getattr(C, sc["fn"]))
    args = [_rank_arg(a, rank, sc.get("dtype")) for a in sc.get("args", ())]
    kw = dict(sc.get("kw", {}))
    for k, v in sc.get("rank_kw", {}).items():
        kw[k] = v[rank]
    if "ps" in sc:
        kw["process_set"] = sets[sc["ps"]]
    if "op" in kw:
        kw["op"] = ReduceOp[kw["op"]]
    if "wire_codec" in kw:
        kw["wire_codec"] = WireCodec(kw["wire_codec"])
    try:
        out = fn(*args, **kw)
    except (NotImplementedError, ValueError) as e:
        if not sc.get("raises"):
            raise
        return {"error": np.asarray(f"{type(e).__name__}: {e}")}
    outs = out if isinstance(out, tuple) else (out,)
    res = {f"out{i}": _np_out(o) for i, o in enumerate(outs)}
    if torch.is_tensor(outs[0]):
        res["dtype"] = np.asarray(str(outs[0].dtype))
    return res


def _topology_scenario(rank, sc, sets):
    """The context's queries and this rank's group along each axis tuple
    of ``sc["axes"]``."""
    from horovod_tpu_torch.runtime import context
    ctx = context.get_context()
    out = {"queries": np.asarray([htt.size(), htt.rank(), htt.local_size(),
                                  htt.local_rank(), htt.cross_size(),
                                  htt.cross_rank(),
                                  int(htt.is_homogeneous())]),
           "flat_axes": np.asarray(",".join(ctx.topology.flat_axes)),
           "shape": np.asarray(ctx.topology.mesh.devices.shape)}
    for axes in sc.get("axes", ()):
        g = ctx.axis_group(tuple(axes))
        out["members|" + ",".join(axes)] = np.asarray(g.members)
        out["index|" + ",".join(axes)] = np.asarray(g.index)
    return out


class _SpyCompressor:
    """A duck-typed per-leaf compressor that counts its calls."""
    calls = {"compress": 0, "decompress": 0}

    @staticmethod
    def compress(t):
        _SpyCompressor.calls["compress"] += 1
        return t, t.dtype

    @staticmethod
    def decompress(t, ctx):
        _SpyCompressor.calls["decompress"] += 1
        return t.to(ctx)


def _transform_scenario(rank, sc, sets):
    """``allreduce_gradients(op, axis, compression)`` over one update of
    this rank's gradients ``grads[k][rank]`` (compression ``"spy"`` is
    :class:`_SpyCompressor`); the synced leaves, the wire trace and the
    spy's call counts."""
    from horovod_tpu_torch.ops.reduce_ops import ReduceOp
    from horovod_tpu_torch.parallel import distributed as D
    comp = sc.get("compression", "none")
    tx = htt.allreduce_gradients(
        op=ReduceOp[sc.get("op", "AVERAGE")], axis=tuple(sc["axis"]),
        compression=_SpyCompressor if comp == "spy" else comp)
    grads = {k: _rank_arg(v, rank) for k, v in sc["grads"].items()}
    synced, _ = tx.update(grads, tx.init(grads))
    out = {f"param|{k}": v.numpy() for k, v in synced.items()}
    out.update(_trace_out(D.last_wire_trace()))
    out["spy_calls"] = np.asarray([_SpyCompressor.calls["compress"],
                                   _SpyCompressor.calls["decompress"]])
    return out


def _trace_out(trace):
    return {f"trace|{k}": np.asarray(v) for k, v in trace.items()}


def _optimizer_scenario(rank, sc, sets):
    from horovod_tpu_torch.parallel import distributed as D
    out = _scenario_optimizer(rank, sc)
    out.update(_trace_out(D.last_wire_trace()))
    return out


_PHASE_SCENARIOS = {"call": _call_scenario, "topology": _topology_scenario,
                    "transform": _transform_scenario,
                    "optimizer": _optimizer_scenario}


def phase_worker(rank, world, port, phases, out_dir):
    """Joins a gloo world, then for each phase: sets its ``env`` (a list
    holds one value per rank; strings are formatted with ``rank``) and
    ``knobs``, ``init(device="cpu", **phase["init"])``, registers its
    ``sets`` (process sets, on every rank), runs its scenarios (each
    saved as ``<name>-rank<r>.npz``) and shuts down."""
    import torch.distributed as dist
    from horovod_tpu_torch.config import knobs
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        for phase in phases:
            os.environ.update({k: str(v[rank] if isinstance(v, list)
                                      else v).format(rank=rank)
                               for k, v in phase.get("env", {}).items()})
            for k, v in phase.get("knobs", {}).items():
                knobs.set_override(k, v)
            htt.init(device="cpu", **phase.get("init", {}))
            try:
                sets = [htt.add_process_set(r)
                        for r in phase.get("sets", ())]
                for sc in phase["scenarios"]:
                    for k, v in sc.get("knobs", {}).items():
                        knobs.set_override(k, v)
                    try:
                        out = _PHASE_SCENARIOS[sc.get("kind", "call")](
                            rank, sc, sets)
                    finally:
                        for k in sc.get("knobs", {}):
                            knobs.clear_override(k)
                    np.savez(os.path.join(out_dir,
                                          f"{sc['name']}-rank{rank}.npz"),
                             **out)
            finally:
                htt.shutdown()
                for k in phase.get("knobs", {}):
                    knobs.clear_override(k)
                for k in phase.get("env", {}):
                    os.environ.pop(k, None)
    finally:
        dist.destroy_process_group()


def run_phases(world, phases, out_dir):
    """Start :func:`phase_worker` in ``world`` ranks; returns ``load(name,
    rank)``, which joins the world on first use."""
    procs = start_world(phase_worker, world, phases, str(out_dir))
    joined = []

    def load(name, rank):
        if not joined:
            joined.append(True)
            join_world(procs)
        return np.load(os.path.join(str(out_dir), f"{name}-rank{rank}.npz"))

    load.procs, load.joined = procs, joined
    return load


# ---------------------------------------------------------------------------
# the resilient train loop: interrupt, kill and resume drills
# ---------------------------------------------------------------------------

class FromCommitted:
    """A resumable batch source: iterating it starts at the newest step
    committed in ``directory`` (0 when none), which is the step
    ``train_loop`` has just restored, since it restores before it
    iterates."""

    def __init__(self, batches, directory):
        self.batches, self.directory = batches, directory

    def __iter__(self):
        from horovod_tpu_torch.resilience import latest_committed_step
        return iter(self.batches[latest_committed_step(self.directory)
                                 or 0:])


def resilient_state(spec, rank):
    """A fresh flagship state and step of ``spec``: ``model`` transformer
    (torch.optim.SGD) or fused (EpilogueSGD in the bucket epilogues, the
    fp8 residual per rank), from ``np_params`` (times 1 + rank: init must
    broadcast rank 0's)."""
    from horovod_tpu_torch.models import transformer as tfm
    cfg = htt.TransformerConfig(**spec["cfg"])
    params = htt.params_from_numpy(tree_util.tree_map(
        lambda a: a * (1 + rank), spec["np_params"]), device="cpu")
    if spec["model"] == "fused":
        da = htt.distributed_apply(htt.EpilogueSGD(0.01, momentum=0.9),
                                   sync_axes=tfm.grad_sync_axes(cfg))
        init_fn, step = htt.make_transformer_train_step_fused(
            cfg, da, device="cpu")
    else:
        init_fn, step = htt.make_transformer_train_step(
            cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
            device="cpu")
    return init_fn(params), step


def resilient_tensors(state):
    """``{"param|i", "mom|i", "res|i": array}`` of a flagship state."""
    leaves = tree_util.tree_leaves(state.params)
    out = {f"param|{i}": t.detach().numpy().copy()
           for i, t in enumerate(leaves)}
    opt = state.opt_state
    if isinstance(opt, torch.optim.Optimizer):
        moms = [opt.state[t]["momentum_buffer"] for t in leaves]
        res = []
    else:
        moms = tree_util.tree_leaves(opt.opt.slots[0])
        res = (tree_util.tree_leaves(opt.residual)
               if isinstance(opt.residual, dict) else [])
    out.update({f"mom|{i}": t.numpy().copy() for i, t in enumerate(moms)})
    out.update({f"res|{i}": t.numpy().copy() for i, t in enumerate(res)})
    return out


def resilient_worker(rank, world, port, spec, out_dir):
    """Runs ``spec["phases"]`` in one gloo world, each from a fresh state
    on this rank's rows of every global batch, through ``train_loop`` with
    an AsyncCheckpointer over the phase's ``dir`` (``interval``): a
    phase's ``chaos`` spec is installed while it runs, ``preempt`` adds a
    PreemptionHandler (margin 0), ``resume`` feeds the batches from the
    restored step on, ``hold`` (``[rank, step]``) has that rank hold every
    free pinned buffer set from the end of that step until the next, so
    its save there finds none. Knobs of ``spec["knobs"]`` hold throughout;
    env ``HVD_RESUME_ATTEMPT`` is the incarnation. Each phase saves
    ``<name>-rank<r>.npz`` (the state's tensors, the info dict as json,
    the committed steps and the saves deferred)."""
    import json
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.resilience import (AsyncCheckpointer,
                                              PreemptionHandler, chaos)
    torch.set_num_threads(1)
    os.environ["HVD_RESUME_ATTEMPT"] = str(spec.get("attempt", 0))
    for k, v in spec.get("knobs", {}).items():
        knobs.set_override(k, v)
    _join_gloo(rank, world, port)
    try:
        b = spec["batches"][0][0].shape[0] // world
        rows = slice(rank * b, (rank + 1) * b)
        batches = [(t[rows], y[rows]) for t, y in spec["batches"]]
        for ph in spec["phases"]:
            state, step = resilient_state(spec, rank)
            ck = AsyncCheckpointer(ph["dir"], interval=ph.get("interval", 1),
                                   max_to_keep=ph.get("keep", 3),
                                   commit_timeout=30)
            handler = (PreemptionHandler(checkpointer=ck, margin=0,
                                         install_signals=False)
                       if ph.get("preempt") else None)
            held = []

            def on_step(i, st, loss, hold=ph.get("hold")):
                while held:
                    ck._pool.release(held.pop())
                if hold is not None and hold == [rank, i]:
                    held.extend(ck._pool.acquire()
                                for _ in ck._pool.free_sets())

            deferred = M.counter("hvd_checkpoint_deferred_total",
                                 "maybe_save calls skipped because a write "
                                 "was still inflight")
            deferred0 = deferred.value
            chaos.install(ph.get("chaos"))
            try:
                source = (FromCommitted(batches, ph["dir"])
                          if ph.get("resume") else batches)
                state, info = htt.train_loop(step, state, source,
                                             checkpointer=ck,
                                             preemption=handler,
                                             on_step=on_step)
                committed = ck.all_steps()
            finally:
                chaos.install(None)
                if handler is not None:
                    handler.close()
                ck.close()
            np.savez(os.path.join(out_dir, f"{ph['name']}-rank{rank}.npz"),
                     info=json.dumps(info), committed=np.asarray(committed),
                     deferred=deferred.value - deferred0,
                     **resilient_tensors(state))
    finally:
        htt.shutdown()
