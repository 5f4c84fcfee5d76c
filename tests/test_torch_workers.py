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
