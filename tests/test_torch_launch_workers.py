"""Worker programs of the port's launcher, elastic and resize tests (no
tests here).

This module imports neither jax nor the JAX package, so a process that
runs it starts in the time it takes to import torch. It is used three
ways:

- as a program under ``hvdrun-torch`` (``python tests/
  test_torch_launch_workers.py elastic_train``): the port's copy of
  ``tests/data/elastic_train.py``, with the same records and the same
  exit schedule, over a ``TorchState`` that also carries a small model and
  its optimizer;
- as the module of the functions ``runner.interactive.run`` pickles
  (``rank_info`` and the others below);
- through :func:`resize_worker`, started by ``test_torch_workers.
  start_world``: the fused tiny flagship at fp8_e4m3 with error feedback
  in a gloo world, shrunk live by chaos ``host_loss`` or cold-started on
  the small world from the committed snapshot and plan.
"""

import gc
import json
import os
import sys
import time

import numpy as np
import torch

# ---------------------------------------------------------------------------
# functions for runner.interactive.run (tests/test_interactive_run.py's)
# ---------------------------------------------------------------------------


def rank_info():
    import horovod_tpu_torch as htt
    return {"rank": htt.rank(), "size": htt.size(),
            "local_size": htt.local_size(), "cross_rank": htt.cross_rank(),
            "cross_size": htt.cross_size(),
            "homogeneous": htt.is_homogeneous()}


def object_collectives():
    import horovod_tpu_torch as htt
    r = htt.rank()
    gathered = htt.allgather_object({"rank": r, "val": r * 10})
    from_root = htt.broadcast_object(
        {"payload": "root-data"} if r == 0 else None, root_rank=0)
    return {"rank": r, "gathered": [g["val"] for g in gathered],
            "bcast": from_root["payload"]}


def broadcast_params():
    import horovod_tpu_torch as htt
    r = htt.rank()
    params = {"w": torch.full((4,), float(r)),
              "b": torch.full((2,), 100.0 + r)}
    synced = htt.broadcast_parameters(params, root_rank=0)
    return {k: v.tolist() for k, v in synced.items()}


def failing_fn():
    raise ValueError("rank exploded")


def with_args(a, b, scale=1):
    import horovod_tpu_torch as htt
    return (a + b) * scale + htt.rank()


# ---------------------------------------------------------------------------
# elastic_train: the port's tests/data/elastic_train.py
# ---------------------------------------------------------------------------

def elastic_train() -> None:
    """Epochs over an ElasticSampler partition, a commit after every
    batch, JSON records appended to ELASTIC_TEST_LOG, and the exit
    schedule ELASTIC_EXIT_SCHEDULE = {"rank:epoch:batch": exit_code}."""
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.elastic import (ElasticSampler, TorchState,
                                           run as elastic_run)
    torch.set_num_threads(1)
    log_path = os.environ["ELASTIC_TEST_LOG"]
    dataset = int(os.environ.get("ELASTIC_TEST_DATASET", "48"))
    epochs = int(os.environ.get("ELASTIC_TEST_EPOCHS", "4"))
    batch = int(os.environ.get("ELASTIC_TEST_BATCH", "4"))
    batch_sleep = float(os.environ.get("ELASTIC_TEST_BATCH_SLEEP", "0.2"))
    schedule = json.loads(os.environ.get("ELASTIC_EXIT_SCHEDULE", "{}"))

    def log(rec):
        rec["pid"] = os.getpid()
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()

    htt.init()
    gen = int(os.environ.get("HVD_ELASTIC_GENERATION", "1"))
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
    sampler = ElasticSampler(dataset_size=dataset, shuffle=False)
    state = TorchState(model=model, optimizer=opt, sampler=sampler,
                       epoch=0, weights=np.zeros((4,), np.float64))

    @elastic_run
    def train(state):
        rank, size = htt.rank(), htt.size()
        log({"type": "start", "gen": gen, "rank": rank, "size": size,
             "epoch": state.epoch})
        while state.epoch < epochs:
            n_batches = int(np.ceil(sampler.num_samples / batch)) \
                if sampler.num_samples else 0
            for b in range(n_batches):
                chunk = sampler.indices[b * batch:(b + 1) * batch]
                key = f"{rank}:{state.epoch}:{b}"
                if schedule.get(key) is not None:
                    log({"type": "crash", "gen": gen, "rank": rank,
                         "epoch": state.epoch, "batch": b})
                    os._exit(int(schedule[key]))
                # "training": the accumulator makes weight continuity
                # checkable, the model takes one SGD step on the chunk
                state.weights = state.weights + np.full(
                    (4,), float(len(chunk)))
                x = torch.tensor(np.asarray(chunk, np.float32)).reshape(
                    -1, 1).repeat(1, 4) / dataset
                opt.zero_grad()
                model(x).sum().backward()
                # synchronous data parallel: no rank records batch b (for
                # every replica) before every rank has reached it
                for p in model.parameters():
                    p.grad = htt.allreduce(p.grad, op=htt.Average)
                opt.step()
                sampler.record_batch(b, batch)
                log({"type": "batch", "gen": gen, "rank": rank,
                     "size": size, "epoch": state.epoch,
                     "idx": [int(i) for i in chunk]})
                time.sleep(batch_sleep)
                state.commit()       # persists + may raise HostsUpdated
            log({"type": "epoch_done", "gen": gen, "rank": rank,
                 "size": size, "epoch": state.epoch,
                 "weights0": float(state.weights[0])})
            state.epoch += 1
            sampler.set_epoch(state.epoch)
            state.commit()
        if rank == 0:
            log({"type": "done", "gen": gen, "size": size,
                 "weights0": float(state.weights[0])})

    train(state)
    htt.shutdown()


def _launch_log(rec) -> None:
    rec.update(attempt=os.environ.get("HVD_RESUME_ATTEMPT"),
               rank=os.environ.get("RANK"),
               world=os.environ.get("WORLD_SIZE"))
    with open(os.environ["LAUNCH_TEST_LOG"], "a") as f:
        f.write(json.dumps(rec) + "\n")


def exit_with(code: str) -> None:
    """Records its HVD_RESUME_ATTEMPT, RANK and WORLD_SIZE in
    $LAUNCH_TEST_LOG and, on attempt 0, exits ``code`` (``kill``: dies to
    SIGKILL); 0 on every later attempt."""
    import signal
    _launch_log({})
    if os.environ.get("HVD_RESUME_ATTEMPT") == "0":
        if code == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        sys.exit(int(code))


def die_or_block() -> None:
    """Records itself in $LAUNCH_TEST_LOG. On attempt 0, rank 1 dies to
    SIGKILL and every other rank blocks (a sleep standing in for the
    collective the dead rank never joins); every later attempt exits 0."""
    import signal
    _launch_log({"pid": os.getpid()})
    if os.environ.get("HVD_RESUME_ATTEMPT") == "0":
        if os.environ.get("RANK") == "1":
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(120)


def world_check() -> None:
    """``init()`` with the launcher's environment, a Sum allreduce of
    rank + 1 over the world, recorded in $LAUNCH_TEST_LOG."""
    import horovod_tpu_torch as htt
    ctx = htt.init()
    total = htt.allreduce(torch.tensor([htt.rank() + 1.0]), op=htt.Sum)
    _launch_log({"size": htt.size(), "sum": float(total[0]),
                 "device": ctx.device.type,
                 "agent_store": os.environ.get(
                     "TORCHELASTIC_USE_AGENT_STORE")})
    htt.shutdown()


# ---------------------------------------------------------------------------
# the live resize on gloo: the fused tiny flagship at fp8 with EF
# ---------------------------------------------------------------------------

def _fused(spec, params):
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.models import transformer as tfm
    cfg = htt.TransformerConfig(**spec["cfg"])
    da = htt.distributed_apply(htt.EpilogueSGD(0.01, momentum=0.9),
                               sync_axes=tfm.grad_sync_axes(cfg))
    init_fn, step = htt.make_transformer_train_step_fused(cfg, da,
                                                          device="cpu")
    return init_fn(params), step


def resize_batch(spec, i, rank, world):
    """Step ``i``'s rows of rank ``rank`` in a world of ``world``: every
    rank takes ``spec["b"]`` rows of a global batch made from seed i."""
    b, s, v = spec["b"], spec["cfg"]["max_seq"] // 8, \
        spec["cfg"]["vocab_size"]
    g = torch.Generator().manual_seed(1000 + i)
    tokens = torch.randint(0, v, (world * b, s), generator=g)
    labels = torch.randint(0, v, (world * b, s), generator=g)
    rows = slice(rank * b, (rank + 1) * b)
    return tokens[rows], labels[rows]


def fused_tensors(state):
    from horovod_tpu_torch.utils import tree as tree_util
    out = {f"param|{i}": t.detach().numpy().copy()
           for i, t in enumerate(tree_util.tree_leaves(state.params))}
    opt = state.opt_state
    out.update({f"mom|{i}": t.numpy().copy() for i, t in
                enumerate(tree_util.tree_leaves(opt.opt.slots[0]))})
    out.update({f"res|{i}": t.numpy().copy() for i, t in
                enumerate(tree_util.tree_leaves(opt.residual))})
    return out


def resize_worker(rank, world, port, spec, out_dir):
    """``spec["mode"]``: ``live`` runs ``spec["steps"]`` steps with a
    ResizeCoordinator (host_size 2) and chaos ``host_loss`` of host 1 at
    ``spec["at"]`` (margin 0): ranks 2-3 leave, 0-1 go on in process; a
    host-0 loss is first refused (rank 0 hosts the env:// store). ``cold``
    is the small world started from the committed snapshot and plan
    (``restore_resized``). Each survivor saves ``<mode>-rank<r>.npz``;
    a rank that left saves ``left-rank<r>.npz``."""
    import horovod_tpu_torch as htt
    from horovod_tpu_torch import elastic
    from horovod_tpu_torch import metrics as M
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.resilience import AsyncCheckpointer, chaos
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK=str(rank % 2), LOCAL_WORLD_SIZE="2")
    knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
    knobs.set_override("HOROVOD_ELASTIC_RESIZE_MARGIN", 0)
    htt.init(device="cpu")
    params = htt.params_from_numpy(spec["np_params"], device="cpu")
    state, step = _fused(spec, params)
    ck = AsyncCheckpointer(spec["dir"], interval=0, commit_timeout=60)
    out = {}
    try:
        if spec["mode"] == "cold":
            start, state = elastic.restore_resized(spec["dir"], state)
            out["restored_step"] = start
        else:
            start = 0
            # an agreed plan to remove host 0 (set directly: the store's
            # plan key of generation 0 is the drill's)
            refused = elastic.ResizeCoordinator(host_size=2)
            refused.agreement._adopted = {
                "stop_step": 0, "notice": {"kind": "host_loss", "host": 0}}
            try:
                refused.resize(0, state)
            except RuntimeError as e:
                out["host0_refusal"] = str(e)
            rc = elastic.ResizeCoordinator(checkpointer=ck, host_size=2)
            chaos.install({"host_loss": {"host": 1,
                                         "at_step": spec["at"]}})
        for i in range(start, spec["steps"]):
            if spec["mode"] == "live":
                rc.poll(i)
                if rc.check(i):
                    state = rc.resize(i, state)
                    if state is elastic.LEFT:
                        np.savez(os.path.join(out_dir,
                                              f"left-rank{rank}.npz"),
                                 step=i, world=htt.is_initialized())
                        return
                    out["resized_at"] = i
                    out["world_after"] = htt.size()
                    out["rank_after"] = htt.rank()
                    out["resize_seconds"] = M.histogram(
                        "hvd_elastic_resize_seconds").total_count
                    out["plan"] = elastic.load_plan(spec["dir"], i).to_json()
                    # the step of the old world holds its process groups:
                    # a step built on the new world takes the live state
                    del step
                    gc.collect()          # the old launcher's hooks go
                    new, step = _fused(spec, state.params)
                    state = new._replace(step=state.step,
                                         opt_state=state.opt_state)
            state, loss = step(state, *resize_batch(spec, i, htt.rank(),
                                                    htt.size()))
        arrays = fused_tensors(state)
        np.savez(os.path.join(out_dir, f"{spec['mode']}-rank{htt.rank()}"
                              ".npz"),
                 meta=json.dumps(out), **arrays)
    finally:
        chaos.install(None)
        ck.close()
        knobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")
        knobs.clear_override("HOROVOD_ELASTIC_RESIZE_MARGIN")
        htt.shutdown()


if __name__ == "__main__":
    name = sys.argv[1]
    if name == "elastic_train":
        elastic_train()
    elif name == "exit_with":
        exit_with(sys.argv[2])
    elif name == "world_check":
        world_check()
    elif name == "die_or_block":
        die_or_block()
    else:
        raise SystemExit(f"unknown worker {name!r}")
