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


def _np_outs(key, out):
    """``{key: array}`` of one eager step's result: a tensor, a list or
    tuple of them (``key|i``), a handle (its name) or a Python value."""
    from horovod_tpu_torch.eager import Handle
    if isinstance(out, (list, tuple)):
        res = {}
        for i, o in enumerate(out):
            res.update(_np_outs(f"{key}|{i}", o))
        return res
    if isinstance(out, Handle):
        return {key: np.asarray(out.name)}
    return {key: _np_out(out)}


def _eager_scenario(rank, sc, sets):
    """A script of calls of the eager API (``horovod_tpu_torch.eager``),
    run in order on every rank. A step is ``fn`` with this rank's parts
    of ``args`` (``as_list``: passed as one list), ``kw`` (``op`` by
    name), ``rank_kw`` (stacked per rank), ``ps`` (index into the phase's
    sets) and ``ref`` (the value an earlier step saved under ``save``) as
    the first argument; ``out`` names its result in the saved file,
    ``raises`` makes a ValueError or NotImplementedError the result. The
    ``fn`` ``clear_registry`` empties a join registry (the set's, or the
    global one), ``reregister`` removes the set and registers it again."""
    from horovod_tpu_torch import eager
    from horovod_tpu_torch.ops.reduce_ops import ReduceOp
    from horovod_tpu_torch.runtime import context
    env, res = {}, {}
    for st in sc["steps"]:
        ps = sets[st["ps"]] if "ps" in st else None
        if st["fn"] == "clear_registry":
            (ps.joined_ranks if ps is not None
             else context.get_context().joined_ranks).clear()
            continue
        if st["fn"] == "reregister":
            htt.remove_process_set(ps)
            htt.add_process_set(ps)
            continue
        args = [_rank_arg(a, rank, st.get("dtype"))
                for a in st.get("args", ())]
        if st.get("as_list"):
            args = [args]
        if "ref" in st:
            args.insert(0, env[st["ref"]])
        kw = dict(st.get("kw", {}))
        for k, v in st.get("rank_kw", {}).items():
            kw[k] = v[rank]
        if "op" in kw:
            kw["op"] = ReduceOp[kw["op"]]
        if ps is not None:
            kw["process_set"] = ps
        try:
            out = getattr(eager, st["fn"])(*args, **kw)
        except (NotImplementedError, ValueError) as e:
            if not st.get("raises"):
                raise
            out = f"{type(e).__name__}: {e}"
        if "save" in st:
            env[st["save"]] = out
        if "out" in st:
            res.update(_np_outs(st["out"], out))
    return res


def mlp_loss(ps, x, y):
    """The two-layer MLP of the Adasum optimizer scenarios (numpy or
    torch parameters ``w1``, ``b1``, ``w2``, ``b2``)."""
    h = x @ ps["w1"] + ps["b1"]
    h = h * (h > 0)
    return ((h @ ps["w2"] + ps["b2"] - y) ** 2).mean()


def _adasum_opt_scenario(rank, sc, sets):
    """``delta``: one SGD(lr) step of DistributedAdasumOptimizer on a
    zero parameter whose gradient is ``grads[rank]`` (the parameter is then
    the combined delta). ``mlp``: two steps of :func:`mlp_loss` from
    ``params`` on this rank's ``xs[rank][t]``, ``ys[rank][t]`` through
    DistributedAdasumOptimizer and through DistributedOptimizer(op=Adasum),
    each over SGD(lr, momentum): the parameters and momentum after."""
    out = {}
    p = torch.zeros(sc["grads"].shape[1], requires_grad=True)
    opt = htt.DistributedAdasumOptimizer(torch.optim.SGD([p], lr=sc["lr"]),
                                         axis="hvd")
    p.grad = _rank_arg(sc["grads"], rank)
    opt.step()
    out["delta"] = p.detach().numpy()
    keys = sorted(sc["params"])
    for kind in ("delta_opt", "grad_opt"):
        ps = {k: torch.tensor(sc["params"][k], requires_grad=True)
              for k in keys}
        sgd = torch.optim.SGD([ps[k] for k in keys], lr=sc["lr"],
                              momentum=sc["momentum"])
        opt = (htt.DistributedAdasumOptimizer(sgd, axis="hvd")
               if kind == "delta_opt"
               else htt.DistributedOptimizer(sgd, op=htt.Adasum))
        for t in range(2):
            mlp_loss(ps, torch.from_numpy(sc["xs"][rank][t]),
                     torch.from_numpy(sc["ys"][rank][t])).backward()
            opt.step()
            opt.zero_grad()
        for k in keys:
            out[f"{kind}|param|{k}"] = ps[k].detach().numpy()
            out[f"{kind}|momentum|{k}"] = \
                sgd.state[ps[k]]["momentum_buffer"].numpy()
    return out


def _seeded_module(seed):
    """A Linear layer and a buffer, from ``seed``."""
    torch.manual_seed(seed)
    m = torch.nn.Linear(3, 2)
    m.register_buffer("stat", torch.full((2,), float(seed)))
    return m


def _objects_scenario(rank, sc, sets):
    """broadcast_parameters (a tree from root 0, a module's parameters
    and buffers from root 1), broadcast_optimizer_state of an Adam that
    only rank 0 stepped (its lr changed too), broadcast_object from root
    2 and allgather_object of each rank's ``batches[rank]``."""
    import json
    out = {}
    tree = {"a": torch.full((3,), float(rank)),
            "b": {"c": torch.full((2, 2), float(rank) + 0.5)}}
    htt.broadcast_parameters(tree, root_rank=0)
    out["tree|a"], out["tree|b|c"] = tree["a"].numpy(), tree["b"]["c"].numpy()
    m = htt.broadcast_parameters(_seeded_module(rank), root_rank=1)
    for k, v in m.state_dict().items():
        out[f"module|{k}"] = v.numpy()
    model = _seeded_module(10)
    adam = torch.optim.Adam(model.parameters(), lr=0.1)
    if rank == 0:
        model(torch.ones(4, 3) * 2).square().sum().backward()
        adam.step()
        adam.param_groups[0]["lr"] = 0.05
    htt.broadcast_optimizer_state(adam, root_rank=0)
    out["opt|lr"] = np.asarray(adam.param_groups[0]["lr"])
    for i, p in enumerate(model.parameters()):
        for k, v in sorted(adam.state[p].items()):
            out[f"opt|{i}|{k}"] = _np_out(v)
    obj = htt.broadcast_object({"epoch": 3, "name": "x", "rank": rank},
                               root_rank=2)
    out["object"] = np.asarray(json.dumps(obj, sort_keys=True))
    out["gathered"] = np.asarray(json.dumps(htt.allgather_object(
        {"rank": rank, "batches": sc["batches"][rank]})))
    return out


def _sync_bn_scenario(rank, sc, sets):
    """The cases of tests/test_sync_batch_norm.py on this rank's rows:
    ``global`` (y, mean, var of ``sync_batch_norm``), ``counts``
    (count-aware statistics of zero-padded rows), ``module``
    (SyncBatchNorm(momentum=0.5): the train output, the running
    statistics, the eval output) and ``grad`` (the gradients of the sums
    over ranks of sum(y^2) and of sum(y * cot))."""
    from horovod_tpu_torch.ops.collectives import bind_axis
    from horovod_tpu_torch.sync_batch_norm import (SyncBatchNorm,
                                                   sync_batch_norm,
                                                   sync_batch_norm_stats)
    out = {}
    with bind_axis("hvd"):
        y, mean, var = sync_batch_norm(_rank_arg(sc["global"], rank), "hvd")
        out.update({"global|y": y.numpy(), "global|mean": mean.numpy(),
                    "global|var": var.numpy()})
        mean, var = sync_batch_norm_stats(
            _rank_arg(sc["padded"], rank), "hvd", (0,),
            count=sc["counts"][rank])
        out.update({"counts|mean": mean.numpy(), "counts|var": var.numpy()})
        for key, cot in (("grad|x", None), ("grad|xc", sc["cot"])):
            x = _rank_arg(sc["grad"], rank).requires_grad_()
            y, _, _ = sync_batch_norm(x, "hvd")
            (y.square() if cot is None else y * _rank_arg(cot, rank)
             ).sum().backward()
            out[key] = x.grad.numpy()
    bn = SyncBatchNorm(sc["module"].shape[-1], momentum=0.5)
    xm = _rank_arg(sc["module"], rank)
    with torch.no_grad():
        out["module|y"] = bn(xm).numpy()
        out["module|mean"] = bn.mean.numpy().copy()
        out["module|var"] = bn.var.numpy().copy()
        bn.eval()
        out["module|y_eval"] = bn(xm).numpy()
    return out


def _callbacks_scenario(rank, sc, sets):
    """scaled_lr; MetricAverageCallback over a metric every rank shares
    and one that differs; BroadcastGlobalVariablesCallback with an
    optimizer; BestModelCheckpoint (to ``dir``/best-rank<r>.pt, rank 0
    only): a save, then no save on a worse value."""
    import os
    from horovod_tpu_torch import callbacks as cb
    out = {"scaled_lr": np.asarray(cb.scaled_lr(0.1))}
    logs = {"metrics": {"loss": 4.0, "acc": float(rank)}}
    cb.MetricAverageCallback().on_epoch_end(0, logs)
    out["loss"], out["acc"] = (logs["metrics"]["loss"].numpy(),
                               logs["metrics"]["acc"].numpy())
    m = _seeded_module(rank)
    sgd = torch.optim.SGD(m.parameters(), lr=0.1 * (rank + 1))
    logs = {"state": m}
    cb.CallbackList([cb.BroadcastGlobalVariablesCallback(0, sgd)]
                    ).on_train_begin(logs)
    out["broadcast|weight"] = logs["state"].weight.detach().numpy()
    out["broadcast|lr"] = np.asarray(sgd.param_groups[0]["lr"])
    path = os.path.join(sc["dir"], f"best-rank{rank}.pt")
    best = cb.BestModelCheckpoint(path, monitor="val_loss")
    best.on_epoch_end(0, {"metrics": {"val_loss": 1.0}, "state": m})
    saved = os.path.exists(path)
    t0 = os.path.getmtime(path) if saved else None
    best.on_epoch_end(1, {"metrics": {"val_loss": 2.0}, "state": m})
    out["best|saved"] = np.asarray(saved)
    out["best|unchanged"] = np.asarray(
        not saved or os.path.getmtime(path) == t0)
    return out


def _value_and_grad_scenario(rank, sc, sets):
    """distributed_value_and_grad on this rank's row of ``x``: a scalar
    parameter synced over ``hvd`` (loss averaged too), and a dict whose
    ``b`` stays local under ``sync_axes`` (with an aux output)."""
    x = _rank_arg(sc["x"], rank)
    vg = htt.distributed_value_and_grad(
        lambda w, xs: ((xs * w) ** 2).mean(), axis="hvd")
    loss, grad = vg(torch.tensor(2.0, requires_grad=True), x)
    ps = {"a": torch.tensor(1.5, requires_grad=True),
          "b": torch.tensor(-0.5, requires_grad=True)}
    vg2 = htt.distributed_value_and_grad(
        lambda p, xs: (((xs * p["a"] + p["b"]) ** 2).mean(), xs.sum()),
        sync_axes={"a": ("hvd",), "b": ()}, has_aux=True)
    (loss2, aux), grads = vg2(ps, x)
    return {"loss": loss.detach().numpy(), "grad": grad.numpy(),
            "loss2": loss2.detach().numpy(), "aux": aux.numpy(),
            "grad|a": grads["a"].numpy(), "grad|b": grads["b"].numpy()}


# ---------------------------------------------------------------------------
# model parallelism: scenarios on a mesh (init(mesh_shape=, axis_names=))
# ---------------------------------------------------------------------------

def _shard_dim(x, axis, dim):
    """This rank's block of ``x`` along ``dim`` by its index along the
    mesh ``axis`` (a name or a tuple)."""
    from horovod_tpu_torch.ops import collectives
    n, i = collectives.axis_size(axis), collectives.axis_rank(axis)
    blk = x.shape[dim] // n
    return x.narrow(dim, i * blk, blk).contiguous()


def _mp_grads_scenario(rank, sc, sets):
    """The flagship's loss and synced gradients on this rank's shards
    (``cfg`` port config, ``params`` global numpy tree, ``tokens`` and
    ``labels`` the global batch), the gradients gathered back to the
    global tree (``g|<i>`` in sorted-key leaf order)."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel import trainer
    cfg = sc["cfg"]
    params = tfm.shard_params(cfg, htt.params_from_numpy(sc["params"],
                                                         device="cpu"))
    leaves, treedef = tree_util.tree_flatten(params)
    for t in leaves:
        t.requires_grad_(True)
    tokens = tfm.shard_batch(cfg, sc["tokens"]).long()
    labels = tfm.shard_batch(cfg, sc["labels"]).long()
    with collectives.bind_axis(*tfm.mesh_axes(cfg)):
        loss = tfm.loss_fn(cfg, params, tokens, labels)
        grads = torch.autograd.grad(loss, leaves)
        grads = trainer.sync_gradients(
            tree_util.tree_unflatten(treedef, list(grads)),
            tfm.grad_sync_axes(cfg), trainer.mesh_world(cfg))
    full = tree_util.tree_leaves(tfm.gather_params(cfg, grads))
    out = {"loss": loss.detach().numpy()}
    out.update({f"g|{i}": g.numpy() for i, g in enumerate(full)})
    return out


def _mp_train_scenario(rank, sc, sets):
    """``steps`` steps of make_transformer_train_step on the mesh with
    Adam(``lr``) from the global ``params``; the losses and the final
    parameters gathered."""
    from horovod_tpu_torch.models import transformer as tfm
    cfg = sc["cfg"]
    init_fn, step = htt.make_transformer_train_step(
        cfg, lambda ps: torch.optim.Adam(ps, lr=sc["lr"]), device="cpu")
    state = init_fn(tfm.shard_params(
        cfg, htt.params_from_numpy(sc["params"], device="cpu")))
    tokens = tfm.shard_batch(cfg, sc["tokens"])
    labels = tfm.shard_batch(cfg, sc["labels"])
    losses = []
    for _ in range(sc["steps"]):
        state, loss = step(state, tokens, labels)
        losses.append(float(loss))
    full = tree_util.tree_leaves(tfm.gather_params(cfg, state.params))
    out = {"losses": np.asarray(losses), "step": np.asarray(state.step)}
    out.update({f"p|{i}": p.numpy() for i, p in enumerate(full)})
    return out


def _mp_fused_scenario(rank, sc, sets):
    """``len(batches)`` steps of make_transformer_train_step_fused on the
    mesh with distributed_apply(EpilogueSGD(0.05, momentum=0.9),
    sync_axes=grad_sync_axes(cfg)) from the global ``params``, each step
    on this rank's block of a global batch: the losses, the parameters
    gathered after every step (``p<t>|<i>``), this rank's error-feedback
    residual after the first step (``r|<i>``, local shapes) and how many
    times each leaf's gradient hook fired in the last step."""
    from horovod_tpu_torch.models import transformer as tfm
    cfg = sc["cfg"]
    da = htt.distributed_apply(htt.EpilogueSGD(0.05, momentum=0.9),
                               sync_axes=tfm.grad_sync_axes(cfg))
    init_fn, step = htt.make_transformer_train_step_fused(cfg, da,
                                                          device="cpu")
    state = init_fn(tfm.shard_params(
        cfg, htt.params_from_numpy(sc["params"], device="cpu")))
    fired = [0] * len(tree_util.tree_leaves(state.params))
    hooks = [p.register_post_accumulate_grad_hook(
        lambda _, i=i: fired.__setitem__(i, fired[i] + 1))
        for i, p in enumerate(tree_util.tree_leaves(state.params))]
    out = {"losses": []}
    for t, (tokens, labels) in enumerate(sc["batches"]):
        fired[:] = [0] * len(fired)
        state, loss = step(state, tfm.shard_batch(cfg, tokens),
                           tfm.shard_batch(cfg, labels))
        out["losses"].append(float(loss))
        full = tree_util.tree_leaves(tfm.gather_params(
            cfg, tree_util.tree_map(lambda p: p.detach(), state.params)))
        # copies: a replicated leaf gathers to the parameter itself, which
        # the next step updates in place
        out.update({f"p{t}|{i}": p.numpy().copy()
                    for i, p in enumerate(full)})
        if t == 0 and state.opt_state.residual:
            out.update({f"r|{i}": r.numpy().copy() for i, r in enumerate(
                tree_util.tree_leaves(state.opt_state.residual))})
    for h in hooks:
        h.remove()
    out["losses"] = np.asarray(out["losses"])
    out["hook_fires"] = np.asarray(fired)
    return out


def _ad_collectives_scenario(rank, sc, sets):
    """Each differentiable collective over the bound axes of ``axes`` on
    this rank's row ``x[rank]``: its output and the gradient of
    ``sum(out * ct[rank])`` (``ct`` a cotangent of the output's shape)."""
    from horovod_tpu_torch.ops import collectives as C
    out = {}
    for op in sc["ops"]:
        name, ax = op["name"], op["axis"]
        x = torch.from_numpy(np.ascontiguousarray(op["x"][rank])
                             ).requires_grad_(True)
        with C.bind_axis(*sc["axes"]):
            if name == "psum":
                y = C.psum(x, ax)
            elif name == "pmean":
                y = C.pmean(x, ax)
            elif name == "pmax":
                y = C.pmax(x, ax) + 0 * x
            elif name == "all_gather":
                y = C.all_gather(x, ax, axis=op["dim"])
            elif name == "all_to_all":
                y = C.all_to_all(x, ax, op["split"], op["concat"])
            elif name == "ppermute":
                y = C.ppermute(x, op["perm"], C.mesh_axis(ax))
            elif name == "axis_index":
                y = x * (1 + C.axis_index(ax)) + C.axis_size(ax)
            ct = torch.from_numpy(np.ascontiguousarray(op["ct"][rank]))
            (g,) = torch.autograd.grad((y * ct).sum(), x)
        out[f"{op['tag']}|out"] = y.detach().numpy()
        out[f"{op['tag']}|grad"] = g.numpy()
    return out


def _sync_scenario(rank, sc, sets):
    """trainer.sync_gradients of this rank's row of each leaf of
    ``grads`` over ``sync`` (axis tuples) with ``world``; and the same
    unbound (the names are mesh axes)."""
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.parallel import trainer
    grads = {k: torch.from_numpy(np.ascontiguousarray(v[rank]))
             for k, v in sc["grads"].items()}
    with C.bind_axis(*sc["axes"]):
        bound = trainer.sync_gradients({k: v.clone() for k, v in
                                        grads.items()}, sc["sync"],
                                       sc["world"])
    free = trainer.sync_gradients(grads, sc["sync"], sc["world"])
    out = {f"bound|{k}": v.numpy() for k, v in bound.items()}
    out.update({f"free|{k}": v.numpy() for k, v in free.items()})
    return out


def _attention_scenario(rank, sc, sets):
    """Ring or Ulysses attention alone on this rank's sequence block of
    the global q, k, v ``[B, S, H, D]`` over the bound ``sp``; the output
    and q/k/v gradients of ``sum(out * dout)`` (this rank's blocks)."""
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.parallel import sequence as sq
    fn = {"ring": sq.ring_attention, "ulysses": sq.ulysses_attention}
    out = {}
    with C.bind_axis("sp"):
        for case in sc["cases"]:
            q, k, v, do = (_shard_dim(torch.from_numpy(case[n]), "sp", 1)
                           for n in ("q", "k", "v", "do"))
            q, k, v = (t.requires_grad_(True) for t in (q, k, v))
            o = fn[case["impl"]](q, k, v, "sp", causal=case["causal"])
            dq, dk, dv = torch.autograd.grad((o * do).sum(), (q, k, v))
            for n, t in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
                out[f"{case['tag']}|{n}"] = t.detach().numpy()
    return out


def _moe_scenario(rank, sc, sets):
    """moe_ffn alone over the bound ``ep`` (of ``axes``): this rank's
    rows of ``x`` along the batch axes, the router replicated, its
    experts' w_in/w_out; the output, the aux loss and the gradients of
    ``sum(out * ct) + aux`` (w_in/w_out gradients gathered over ep, the
    router's summed over the batch axes)."""
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.parallel import moe
    batch_axes = tuple(sc["batch_axes"])
    x = _shard_dim(torch.from_numpy(sc["x"]), batch_axes, 0)
    ct = _shard_dim(torch.from_numpy(sc["ct"]), batch_axes, 0)
    router = torch.from_numpy(sc["router"])
    w_in = _shard_dim(torch.from_numpy(sc["w_in"]), "ep", 0)
    w_out = _shard_dim(torch.from_numpy(sc["w_out"]), "ep", 0)
    ts = [t.requires_grad_(True) for t in (x, router, w_in, w_out)]
    with C.bind_axis(*sc["axes"]):
        y, metrics = moe.moe_ffn(*ts, ep_axis="ep",
                                 capacity_factor=sc["capacity_factor"])
        grads = torch.autograd.grad((y * ct).sum() + metrics.aux_loss, ts)
    return {"out": y.detach().numpy(), "aux": metrics.aux_loss.detach()
            .numpy(), "dropped": metrics.dropped_fraction.numpy(),
            **{f"d|{n}": g.numpy() for n, g in
               zip(("x", "router", "w_in", "w_out"), grads)}}


def _pipeline_scenario(rank, sc, sets):
    """pipeline_apply alone over the bound ``pp``: stage s applies
    ``tanh(mb @ w[s])`` (w ``[pp, D, D]`` sharded over pp) to ``x``
    ``[M, mb, D]``; the outputs and the gradients of ``sum(out * ct)``
    with respect to x and this rank's stage weight."""
    from horovod_tpu_torch.ops import collectives as C
    from horovod_tpu_torch.parallel import pipeline
    x = torch.from_numpy(sc["x"]).requires_grad_(True)
    w = _shard_dim(torch.from_numpy(sc["w"]), "pp", 0)[0].requires_grad_(
        True)
    with C.bind_axis("pp"):
        y = pipeline.pipeline_apply(lambda mb: torch.tanh(mb @ w), x, "pp")
        dx, dw = torch.autograd.grad((y * torch.from_numpy(sc["ct"])).sum(),
                                     (x, w))
    return {"out": y.detach().numpy(), "dx": dx.numpy(), "dw": dw.numpy()}


def _serve_tp_scenario(rank, sc, sets):
    """A tensor-parallel ServeEngine (global ``params``, ``engine``
    keyword arguments) and a ServeScheduler over ``prompts``: every
    request's tokens (``t|<rid>``), the engine's first prefill logits and,
    with a drafter, the scheduler's ``proposed``/``accepted`` tallies."""
    from horovod_tpu_torch import Request, ServeEngine, ServeScheduler
    eng = ServeEngine(sc["cfg"], sc["params"], device="cpu",
                      **sc["engine"])
    slot = eng.reserve(len(sc["prompts"][0]) + 1)
    eng.prefill(slot, np.asarray(sc["prompts"][0], np.int32))
    first = eng.last_logits.numpy().copy()
    eng.release(slot)
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32),
                    max_new_tokens=sc["new_tokens"])
            for i, p in enumerate(sc["prompts"])]
    sched = ServeScheduler(eng, queue_deadline=0.0, device="cpu")
    done = sched.run(reqs)
    out = {f"t|{r.rid}": np.asarray(r.tokens) for r in done}
    out.update(first_logits=first, tp=np.asarray(eng.stats()["tp"]),
               kv_heads=np.asarray(eng.k_pages.shape[3]))
    spec = sched.stats()["spec"]
    if spec is not None:
        out.update(proposed=np.asarray(spec["proposed"]),
                   accepted=np.asarray(spec["accepted"]))
    return out


# ---------------------------------------------------------------------------
# the control plane: one script run by both packages' coordinators
# ---------------------------------------------------------------------------

def run_coord_script(sc, api):
    """Run the coordinator script ``sc["steps"]`` through ``api`` (an
    adapter over one package: ``coord``, ``ctx``, ``knobs``,
    ``call(fn, x, kw)``, ``enqueue_raw(op_type, x, name, kw)``,
    ``arr(key)``, ``ps(i)``, ``op(name)``, ``to_np(value)``,
    ``timeline(path or None)``). Steps: ``enqueue`` (``fn`` on ``arg`` or
    the list ``args``, ``name``, ``kw``, ``ps``, ``raises``), ``raw`` (the
    package's ``_enqueue_async``), ``cycle``, ``wait``/``sync``/``poll``
    (of ``name``; ``out`` keeps the result; ``raises`` keeps the error's
    type), ``call`` (a synchronous ``fn`` on ``arg``, kept as ``out``),
    ``done`` (``quiet``: not recorded), ``knob``/``unknob``, ``capacity``, ``join``/
    ``join_clear``, ``probe`` (dispatched programs and queue length),
    ``min_threshold``, ``threshold_for``, ``timeline_start``/
    ``timeline_stop`` and ``coord_shutdown``. Returns the bins (member
    names per dispatched bin, in order), the ``stats``, the cache's
    (hits, misses, evictions), the per-step records and the kept
    values."""
    coord = api.coord
    bins, records, values, handles, knobs_set = [], [], {}, {}, set()
    orig = coord._dispatch_bin

    def recording(entries, *rest):
        bins.append([e.name for e in entries])
        return orig(entries, *rest)

    coord._dispatch_bin = recording
    try:
        for st in sc["steps"]:
            do = st["do"]
            if do in ("enqueue", "raw"):
                kw = dict(st.get("kw", {}))
                if "op" in kw:
                    kw["op"] = api.op(kw["op"])
                if "ps" in st:
                    kw["process_set"] = api.ps(st["ps"])
                x = ([api.arr(k) for k in st["args"]] if "args" in st
                     else api.arr(st["arg"]))
                try:
                    if do == "raw":
                        h = api.enqueue_raw(st["op_type"], x, st["name"], kw)
                    else:
                        h = api.call(st["fn"], x, dict(kw, name=st["name"]))
                except Exception as e:
                    if not st.get("raises"):
                        raise
                    records.append(type(e).__name__)
                    continue
                handles[st["name"]] = h
            elif do == "cycle":
                records.append(int(coord.run_cycle()))
            elif do in ("wait", "sync"):
                try:
                    out = handles[st["name"]].wait()
                except Exception as e:
                    if not st.get("raises"):
                        raise
                    records.append(type(e).__name__)
                    continue
                if "out" in st:
                    values[st["out"]] = api.to_np(out)
            elif do == "call":
                kw = {"op": api.op(st["op"])} if "op" in st else {}
                values[st["out"]] = api.to_np(api.call(
                    st["fn"], api.arr(st["arg"]), kw))
            elif do in ("done", "poll"):
                done = bool(handles[st["name"]].done())
                if not st.get("quiet"):
                    records.append(done)
            elif do == "knob":
                for k, v in st["set"].items():
                    api.knobs.set_override(k, v)
                    knobs_set.add(k)
            elif do == "unknob":
                for k in st["names"]:
                    api.knobs.clear_override(k)
            elif do == "capacity":
                coord.cache.capacity = st["value"]
            elif do == "join":
                api.ctx.joined_ranks.append(st["rank"])
            elif do == "join_clear":
                api.ctx.joined_ranks.clear()
            elif do == "probe":
                records.append([coord.stats.dispatched_programs,
                                len(coord.queue)])
            elif do == "min_threshold":
                records.append(int(coord._min_threshold()))
            elif do == "threshold_for":
                records.append(int(coord._threshold_for(st["kind"])))
            elif do == "timeline_start":
                api.timeline(st["path"])
            elif do == "timeline_stop":
                api.timeline(None)
            elif do == "coord_shutdown":
                coord.shutdown()
            else:
                raise ValueError(f"unknown step {do!r}")
    finally:
        coord._dispatch_bin = orig
        for k in knobs_set:
            api.knobs.clear_override(k)
    st = coord.stats
    return {"bins": bins, "records": records, "values": values,
            "stats": [st.cycles, st.tensors, st.dispatched_programs,
                      st.fused_tensors_max],
            "cache": [coord.cache.hits, coord.cache.misses,
                      coord.cache.evictions]}


class _PortCoordAPI:
    """:func:`run_coord_script`'s adapter over the port, rank ``rank``'s
    row of every array."""

    def __init__(self, rank, sc, sets, coord):
        from horovod_tpu_torch.config import knobs
        from horovod_tpu_torch.runtime import context
        self.rank, self.sc, self.sets = rank, sc, sets
        self.coord, self.knobs = coord, knobs
        self.ctx = context.get_context()

    def arr(self, key):
        return torch.from_numpy(np.ascontiguousarray(
            self.sc["arrays"][key][self.rank]))

    def ps(self, i):
        return self.sets[i]

    def op(self, name):
        from horovod_tpu_torch.ops.reduce_ops import ReduceOp
        return ReduceOp[name]

    def call(self, fn, x, kw):
        return getattr(htt, fn)(x, **kw)

    def enqueue_raw(self, op_type, x, name, kw):
        from horovod_tpu_torch import eager
        return eager._enqueue_async(op_type, x, name, **kw)

    def to_np(self, v):
        if isinstance(v, (list, tuple)):
            return [self.to_np(e) for e in v]
        return v.detach().cpu().numpy()

    def timeline(self, path):
        if path is None:
            htt.stop_timeline()
        else:
            htt.start_timeline(path.format(rank=self.rank))


def _coord_scenario(rank, sc, sets):
    """A control-plane script (:func:`run_coord_script`) on a fresh
    coordinator: thread-less (``Coordinator(ctx, start_thread=False)``,
    as the JAX tests' ``manual_coord``), deterministic where ``det`` says
    so (a world of several ranks always is), or, with ``lazy``, the
    context's own from ``get_coordinator`` (its cycle thread in a world
    of one). Saves the script's record as JSON (with ``thread``: whether
    a cycle thread ran, and still runs after ``shutdown``), the plan
    cache's ``builds`` and ``store_hits`` (``store_counts``) and each kept
    value."""
    import json
    from horovod_tpu_torch.ops.coordinator import Coordinator, get_coordinator
    from horovod_tpu_torch.runtime import context
    ctx = context.get_context()
    if ctx.coordinator is not None:
        ctx.coordinator.shutdown()
        ctx.coordinator = None
    if sc.get("lazy"):
        coord = get_coordinator(ctx)
    else:
        coord = Coordinator(ctx, start_thread=False)
        ctx.coordinator = coord
    if sc.get("det"):
        coord.deterministic = True
    res = run_coord_script(sc, _PortCoordAPI(rank, sc, sets, coord))
    snap = coord.cache.snapshot()
    alive = coord._thread is not None and coord._thread.is_alive()
    coord.shutdown()
    res["thread"] = [alive, coord._thread is not None
                     and coord._thread.is_alive()]
    ctx.coordinator = None
    out = {"record": np.asarray(json.dumps({k: v for k, v in res.items()
                                            if k != "values"})),
           # the plans made and the plans the artifact store served
           "store_counts": np.asarray([snap["builds"], snap["store_hits"]])}
    for key, v in res["values"].items():
        if isinstance(v, list):
            for i, e in enumerate(v):
                out[f"{key}|{i}"] = e
        else:
            out[key] = v
    return out


def _divergence_scenario(rank, sc, sets):
    """One divergence case of a two-rank world on a fresh coordinator
    (``case``): ``clean`` (identical programs, three bursts), ``extra``
    (rank 1 enqueues a tensor rank 0 never does), ``widened`` (the same
    once the check interval has widened to 4, at a flush rank 0 dispatches
    unchecked; rank 1 then enters rank 0's collective, so the world goes
    on), ``never`` (rank 1 never flushes), or ``cadence`` (the checker
    alone over the c10d store, rank 1's adaptive interval desynced after
    two clean flushes). Saves the error text (empty when none), the
    seconds taken and the checks made; every rank ends at a barrier."""
    import time
    import torch.distributed as dist
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops.coordinator import Coordinator, Entry
    from horovod_tpu_torch.ops.divergence import (DivergenceChecker,
                                                  DivergenceError)
    from horovod_tpu_torch.runtime import context
    from horovod_tpu_torch.utils.kvstore import distributed_kv
    ctx = context.get_context()
    if ctx.coordinator is not None:
        ctx.coordinator.shutdown()
    coord = Coordinator(ctx, start_thread=False)
    ctx.coordinator = coord
    checker = coord.divergence_checker
    x = torch.ones(8)
    error, t0 = "", time.perf_counter()
    try:
        if sc["case"] == "clean":
            for i in range(3):
                hs = [htt.allreduce_async(x * (i + 1), name=f"g{i}_{j}")
                      for j in range(4)]
                for h in hs:
                    htt.synchronize(h)
        elif sc["case"] == "extra":
            if rank == 1:
                htt.allreduce_async(x, name="extra_tensor")
            htt.synchronize(htt.allreduce_async(x, name="shared_grad"))
        elif sc["case"] == "widened":
            knobs.set_override("HOROVOD_DIVERGENCE_CHECK_MAX_INTERVAL", 4)
            while not (checker.effective_interval == 4
                       and checker._since_check == 0):
                htt.synchronize(htt.allreduce_async(x, name="steady"))
            t0 = time.perf_counter()
            try:
                if rank == 1:
                    htt.allreduce_async(x, name="late_extra")
                htt.synchronize(htt.allreduce_async(x, name="steady"))
            finally:
                knobs.clear_override("HOROVOD_DIVERGENCE_CHECK_MAX_INTERVAL")
                if rank == 1:       # rank 0's collective is still in flight
                    htt.allreduce(x, name="release")
        elif sc["case"] == "never":
            h = htt.allreduce_async(x, name="lonely")
            if rank == 0:
                htt.synchronize(h)
        else:
            checker = DivergenceChecker(
                distributed_kv(site="divergence"), rank, 2,
                prefix=f"hvd/test/{sc['name']}")
            for i in (1, 2):
                checker.observe(i, [Entry("g", "allreduce", x, None)])
            dist.barrier()
            checker._effective, checker._streak = 1 + rank, 0
            for i in (3, 4):
                checker.observe(i, [Entry("g", "allreduce", x, None)])
    except DivergenceError as e:
        error = str(e)
    seconds = time.perf_counter() - t0
    coord.reset(RuntimeError("case over"))
    ctx.coordinator = None
    dist.barrier()
    return {"error": np.asarray(error), "seconds": np.asarray(seconds),
            "checks": np.asarray(checker.checks)}


def _frontend_leaves(v, prefix, out):
    """Record one result of the DLPack bridge: per leaf (lists and tuples
    walked) its framework (the root of its type's module), its dtype's
    name and its value as float64 or int64 numpy."""
    if isinstance(v, (list, tuple)):
        for i, e in enumerate(v):
            _frontend_leaves(e, f"{prefix}|{i}", out)
        return
    out[f"{prefix}|type"] = np.asarray(type(v).__module__.split(".")[0])
    out[f"{prefix}|dtype"] = np.asarray(str(v.dtype).replace("torch.", ""))
    arr = np.asarray(v.astype(np.float64) if v.dtype.name == "bfloat16"
                     else v) if isinstance(v, np.ndarray) else \
        v.detach().double().numpy() if v.is_floating_point() else \
        v.detach().numpy()
    out[prefix] = arr


def _dlpack_scenario(rank, sc, sets):
    """Each of ``calls`` (``fn`` of the public API on this rank's rows of
    the numpy ``arg``, or of each of ``args`` as a list; ``kw``, with
    ``op`` by name and ``rank_kw`` stacked per rank; ``wait``: an async
    form, synchronized) with numpy inputs through the DLPack bridge;
    each result recorded by :func:`_frontend_leaves`."""
    from horovod_tpu_torch.ops.reduce_ops import ReduceOp
    out = {}
    for call in sc["calls"]:
        x = ([np.ascontiguousarray(a[rank]) for a in call["args"]]
             if "args" in call else np.ascontiguousarray(call["arg"][rank]))
        kw = dict(call.get("kw", {}))
        for k, v in call.get("rank_kw", {}).items():
            kw[k] = v[rank]
        if "op" in kw:
            kw["op"] = ReduceOp[kw["op"]]
        res = getattr(htt, call["fn"])(x, **kw)
        if call.get("wait"):
            res = htt.synchronize(res)
        _frontend_leaves(res, call["name"], out)
    return out


def _metrics_agg_scenario(rank, sc, sets):
    """The metrics exports across ranks: each rank adds ``rank + 1`` to
    the counter ``sc["marker"]``; the ranks but 0 publish their snapshots
    to the c10d store (``init`` started their publishers), and rank 0
    scrapes its own ``/metrics`` until the merged sum holds every rank's
    part (``sc["timeout_s"]``). Saves rank 0's merged value and whether
    its scrape showed it; every rank then meets at a barrier."""
    import time
    import urllib.request
    import torch.distributed as dist
    from horovod_tpu_torch import metrics as M
    M.counter(sc["marker"], "aggregation marker").inc(rank + 1)
    want = sum(r + 1 for r in range(dist.get_world_size()))
    merged, scraped = -1.0, False
    if rank == 0:
        srv = M.start_metrics_server(0, host="127.0.0.1")
        deadline = time.monotonic() + sc.get("timeout_s", 20.0)
        while time.monotonic() < deadline:
            snap = M.metrics_snapshot(aggregate=True)
            merged = snap[sc["marker"]]["series"][0]["value"]
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
                scraped = f"{sc['marker']} {want}" in r.read().decode()
            if merged == want and scraped:
                break
            time.sleep(0.05)
    dist.barrier()
    return {"merged": np.asarray(merged), "scraped": np.asarray(scraped),
            "want": np.asarray(want)}


def _observe_scenario(rank, sc, sets):
    """The observability hooks in a world of several ranks: ``train_loop``
    over this rank's rows of ``sc["batches"]`` (global ``(x, y)`` numpy
    pairs) of a three-layer MLP through DistributedOptimizer, under the
    phase's HOROVOD_TRACE_PROFILE, HOROVOD_NUMERICS and bucket knobs; then,
    with ``sc["nan"]``, two ``allreduce_async`` through the coordinator,
    rank 0's first holding a NaN, and the monitor drained; then arms
    ``sc["clock_skew"]`` seconds of chaos clock skew on rank 1 for the
    trace merge that ``shutdown`` exports. Saves the loop's info, the
    profile attribution (JSON text, "" when none was written), the
    monitor's anomalies (JSON) and this rank's span epoch."""
    import json
    from horovod_tpu_torch.goodput import numerics
    from horovod_tpu_torch.parallel import trainer
    from horovod_tpu_torch.resilience import chaos
    from horovod_tpu_torch.tracing import profile
    from horovod_tpu_torch.tracing import spans
    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Linear(16, 32), torch.nn.ReLU(), torch.nn.Linear(32, 32),
        torch.nn.ReLU(), torch.nn.Linear(32, 4))
    opt = htt.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.01))

    def loss_fn(m, x, y):
        return ((m(x) - y) ** 2).mean()

    init_fn, step, put = trainer.data_parallel_train_step(loss_fn, opt,
                                                          device="cpu")
    state = init_fn(model)
    batches = [put((torch.from_numpy(x), torch.from_numpy(y)))
               for x, y in sc["batches"]]
    with spans.span("observe.train", cat="train"):
        state, info = htt.train_loop(step, state, batches)
    out = {"final_step": info["final_step"], "n_buckets": len(opt.buckets)}
    path = os.path.join(profile._default_log_dir(),
                        "profile_attribution.json")
    out["attribution"] = open(path).read() if os.path.exists(path) else ""
    mon = numerics.get_monitor()
    if sc.get("nan"):
        x = torch.ones(4, 8)
        if rank == 0:
            x[1, 2] = float("nan")
        h1 = htt.allreduce_async(x, name="num_bad", op=htt.Sum)
        h2 = htt.allreduce_async(torch.ones(3), name="num_good", op=htt.Sum)
        htt.synchronize(h1)
        htt.synchronize(h2)
        mon.drain()
    out["anomalies"] = json.dumps(mon.anomalies if mon is not None else [])
    if sc.get("clock_skew"):
        chaos.install({"clock_skew": {"offset": sc["clock_skew"],
                                      "hosts": [1]}})
    out["epoch_unix"] = spans.epoch_unix()
    return {k: np.asarray(v) for k, v in out.items()}


def _autotune_scenario(rank, sc, sets):
    """The tuner across ranks, by ``sc["drill"]``:

    - ``tune``: ``sc["steps"]`` eager allreduces, each synchronized (a
      deterministic flush, so a cycle) with HOROVOD_AUTOTUNE on; saves
      the synchronizer's history and flags, the tuner's, the sums and the
      tunable knobs after the last cycle;
    - ``dims``: the coordinator's tuner dimensions on this topology;
    - ``prefix``: two ``make_parameter_synchronizer`` prefixes;
    - ``shed``: rank 0 exhausts the ``autotune`` site, sets
      HOROVOD_CYCLE_TIME and publishes cycle 3; rank 1 applies it;
    - ``timeout``: rank 1 applies a cycle rank 0 never publishes, with a
      timeout of ``sc["timeout_s"]``; saves the error's text;
    - ``broadcast``: ``_broadcast_resolution`` of a per-rank value, and
      ``resolve_bucket_bytes`` under 'auto' with a cache only rank 0 has.

    Every rank meets at a barrier at the end; the tuner's overrides are
    cleared."""
    import json
    import time
    import torch.distributed as dist
    from horovod_tpu_torch import autotune
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.ops.coordinator import get_coordinator
    from horovod_tpu_torch.resilience import faults
    from horovod_tpu_torch.runtime.context import get_context
    from horovod_tpu_torch.utils.kvstore import distributed_kv
    drill, out = sc["drill"], {}
    try:
        if drill == "tune":
            sums = []
            for step in range(sc["steps"]):
                h = htt.allreduce_async(
                    torch.full((4,), float(rank + step)), op=htt.Sum,
                    name=f"at/{step}")
                sums.append(htt.synchronize(h).numpy())
            coord = get_context().coordinator
            sync = coord._param_sync
            out = {"history": np.asarray(json.dumps(sync.history)),
                   "prefix": np.asarray(sync._prefix),
                   "is_leader": np.asarray(sync.is_leader),
                   "done": np.asarray(sync.done),
                   "tuning": np.asarray(coord.autotune.enabled),
                   "converged": np.asarray(coord.autotune.converged),
                   "samples": np.asarray(coord.autotune._samples),
                   "sums": np.stack(sums),
                   "knobs": np.asarray(json.dumps(
                       autotune.ParameterSynchronizer._tunable_snapshot(),
                       sort_keys=True))}
        elif drill == "dims":
            coord = get_coordinator(get_context())
            out = {"hierarchical": np.asarray(
                       get_context().topology.is_hierarchical),
                   "dims": np.asarray(coord.autotune._opt.dims),
                   "continuous": np.asarray(
                       [d[0] for d in coord.autotune._continuous])}
        elif drill == "prefix":
            out = {"prefixes": np.asarray([
                autotune.make_parameter_synchronizer()._prefix
                for _ in range(2)])}
        elif drill == "shed":
            sync = autotune.ParameterSynchronizer(
                distributed_kv(site="autotune"), leader=rank == 0,
                prefix=sc["prefix"])
            if rank == 0:
                faults.register_policy(faults.RetryPolicy(
                    site="autotune", deadline_s=5.0, base_backoff_s=0.001,
                    max_backoff_s=0.002, max_attempts=1, jitter=0.0,
                    critical=False))
                try:
                    faults.retry_call("autotune", lambda: (
                        _ for _ in ()).throw(ConnectionError("UNAVAILABLE")))
                except faults.RetryBudgetExhausted:
                    pass
                knobs.set_override("HOROVOD_CYCLE_TIME", 7.5)
            shed = faults.should_shed("autotune")
            if rank == 0:
                sync.publish(3, converged=False)
            else:
                sync.apply(3)
            out = {"done": np.asarray(sync.done),
                   "frozen": np.asarray(sync.frozen),
                   "shed": np.asarray(shed),
                   "cycle_time": np.asarray(knobs.get("HOROVOD_CYCLE_TIME")),
                   "history": np.asarray(json.dumps(sync.history))}
        elif drill == "timeout":
            text, seconds = "", 0.0
            if rank == 1:
                sync = autotune.ParameterSynchronizer(
                    distributed_kv(site="autotune"), leader=False,
                    prefix=sc["prefix"], timeout=sc["timeout_s"])
                t0 = time.monotonic()
                try:
                    sync.apply(1)
                except RuntimeError as e:
                    text = str(e)
                seconds = time.monotonic() - t0
            out = {"error": np.asarray(text), "seconds": np.asarray(seconds)}
        elif drill == "broadcast":
            got = autotune._broadcast_resolution(
                sc["sig"], sc["local"][rank])
            knobs.set_override("HOROVOD_BUCKET_AUTO_CACHE",
                               sc["caches"][rank])
            knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", "auto")
            if rank == 0:
                autotune.bucket_cache_store(
                    autotune.grad_signature(sc["leaves"], 2), sc["cached"])
            dist.barrier()
            resolved = autotune.resolve_bucket_bytes(sc["leaves"], 2)
            out = {"adopted": np.asarray(got),
                   "resolved": np.asarray(resolved),
                   "missed": np.asarray(len(autotune._auto_miss_warned))}
    finally:
        knobs.clear_all_overrides()
        faults.reset_for_tests()
    dist.barrier()
    return out


_PHASE_SCENARIOS = {"call": _call_scenario, "topology": _topology_scenario,
                    "eager": _eager_scenario,
                    "adasum_opt": _adasum_opt_scenario,
                    "objects": _objects_scenario,
                    "sync_bn": _sync_bn_scenario,
                    "callbacks": _callbacks_scenario,
                    "value_and_grad": _value_and_grad_scenario,
                    "transform": _transform_scenario,
                    "optimizer": _optimizer_scenario,
                    "mp_grads": _mp_grads_scenario,
                    "mp_train": _mp_train_scenario,
                    "mp_fused": _mp_fused_scenario,
                    "ad_collectives": _ad_collectives_scenario,
                    "sync": _sync_scenario,
                    "attention": _attention_scenario,
                    "moe": _moe_scenario,
                    "pipeline": _pipeline_scenario,
                    "serve_tp": _serve_tp_scenario,
                    "coord": _coord_scenario,
                    "divergence": _divergence_scenario,
                    "dlpack": _dlpack_scenario,
                    "metrics_agg": _metrics_agg_scenario,
                    "observe": _observe_scenario,
                    "autotune": _autotune_scenario}


def phase_worker(rank, world, port, phases, out_dir):
    """Joins a gloo world, then for each phase: sets its ``env`` (a list
    holds one value per rank; strings are formatted with ``rank``) and
    ``knobs`` (and ``threads``: torch's intra-op threads),
    ``init(device="cpu", **phase["init"])``, registers its
    ``sets`` (process sets, on every rank), runs its scenarios (each
    saved as ``<name>-rank<r>.npz``) and shuts down."""
    import torch.distributed as dist
    from horovod_tpu_torch.config import knobs
    if world > 4:       # eight ranks share a few cores
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        for phase in phases:
            if phase.get("threads"):
                torch.set_num_threads(phase["threads"])
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


def _phase_file_worker(rank, world, port, path, out_dir):
    import pickle
    with open(path, "rb") as f:
        phases = pickle.load(f)
    phase_worker(rank, world, port, phases, out_dir)


def run_phases(world, phases, out_dir):
    """Start :func:`phase_worker` in ``world`` ranks; returns ``load(name,
    rank)``, which joins the world on first use. The phases reach the
    ranks through a file in ``out_dir``: a spawned process reads its
    arguments only once it has imported torch, so arguments larger than
    a pipe's buffer would start the ranks one after another."""
    import pickle
    path = os.path.join(str(out_dir), "phases.pkl")
    with open(path, "wb") as f:
        pickle.dump(phases, f)
    procs = start_world(_phase_file_worker, world, path, str(out_dir))
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
