"""Tensor-parallel serving of the port against the JAX package's, on the
CPU.

The tiny config of ``tests/test_torch_serving.py`` (d=64, H=4, Dh=16,
L=2, V=256, f32; slots 4, page 16, chunk 64) with ``tp_axis="tp"``: one
port engine per rank of a 4-rank gloo world on a (tp 4) mesh
(``test_torch_workers.run_phases``), each built from the same global JAX
weights and keeping its shard (one head and one KV head a rank, a
quarter of the FFN and of the vocabulary), every rank running the same
``ServeScheduler`` on the same requests. Greedy tokens, over every step
of the scheduler, must equal the JAX ``ServeEngine`` on a (tp 4) mesh of
``jax.devices()[:4]`` on every rank; the first prefill's logits are held
within 1e-4 of the JAX model's (f32; the sums run in another order).
A second phase of the same world re-inits on a (dp 2, tp 2) mesh and
serves the same requests at tp2 with ``HOROVOD_SERVE_DRAFT=ngram:3``:
every rank's tokens must be those of one device.
"""

import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from horovod_tpu.models import transformer as jtfm
from horovod_tpu.serving import Request as JRequest
from horovod_tpu.serving import ServeEngine as JServeEngine
from horovod_tpu.serving import ServeScheduler as JServeScheduler
from horovod_tpu_torch import TransformerConfig
import test_torch_serving as ts
import test_torch_workers as workers

LIMIT_S = 120
W = 4
NEW_TOKENS = 8
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _limit():
    def expired(*_):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")
    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(scope="module")
def jparams():
    return jtfm.init_params(ts._jcfg(), jax.random.PRNGKey(0))


PROMPTS = ts._prompts(5, 6)
SPEC_ENGINE = {**ts.ENGINE_KW, "draft": "ngram:3", "spec_k": 4}


@pytest.fixture(scope="module")
def port_world(jparams, tmp_path_factory):
    cfg = TransformerConfig(**{**ts.CFG_KW, "dtype": torch.float32,
                               "tp_axis": "tp"})
    phases = [dict(init=dict(mesh_shape=(W,), axis_names=("tp",)),
                   scenarios=[dict(name="serve", kind="serve_tp", cfg=cfg,
                                   params=ts._np_tree(jparams),
                                   engine=ts.ENGINE_KW,
                                   prompts=[p.tolist() for p in PROMPTS],
                                   new_tokens=NEW_TOKENS)]),
              # speculative serving at tp2: two tp groups of two ranks
              dict(init=dict(mesh_shape=(2, W // 2),
                             axis_names=("dp", "tp")),
                   scenarios=[dict(name="serve_spec", kind="serve_tp",
                                   cfg=cfg, params=ts._np_tree(jparams),
                                   engine=SPEC_ENGINE,
                                   prompts=[p.tolist() for p in PROMPTS],
                                   new_tokens=NEW_TOKENS)])]
    load = workers.run_phases(W, phases, tmp_path_factory.mktemp("tp_serve"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


def test_tp_engine_tokens_match_jax_tp_engine(port_world, jparams):
    mesh = Mesh(np.array(jax.devices()[:W]), ("tp",))
    jeng = ts._synchronous(JServeEngine(ts._jcfg(tp_axis="tp"), jparams,
                                        mesh=mesh, **ts.ENGINE_KW))
    jdone = JServeScheduler(jeng, queue_deadline=0.0).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
         for i, p in enumerate(PROMPTS)])
    theirs = {r.rid: list(r.tokens) for r in jdone}
    assert len(theirs) == len(PROMPTS)
    for rank in range(W):
        got = port_world("serve", rank)
        ours = {i: got[f"t|{i}"].tolist() for i in range(len(PROMPTS))}
        assert ours == theirs, f"rank {rank}"
        assert all(len(t) == NEW_TOKENS for t in ours.values())
        assert int(got["tp"]) == W
        assert int(got["kv_heads"]) == ts.CFG_KW["n_heads"] // W


def test_tp_engine_first_logits_match_jax_model(port_world, jparams):
    prompt = jnp.asarray(PROMPTS[0])[None]
    want = np.asarray(jtfm.logits_fn(ts._jcfg(), jparams, prompt)[0, -1])
    for rank in range(W):
        got = port_world("serve", rank)["first_logits"]
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL, err_msg=f"rank {rank}")


def test_tp2_ngram_speculation_gives_the_tokens_of_one_rank(port_world,
                                                           jparams):
    """HOROVOD_SERVE_DRAFT=ngram:3 at tp2 (each rank of a (dp 2, tp 2)
    mesh an engine on its tp group): every rank's tokens are the
    sequential tokens of the JAX engine on one device, and its
    proposed/accepted tallies those of the JAX ngram:3 engine on one
    device."""
    reqs = [JRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(PROMPTS)]
    off = JServeScheduler(ts._synchronous(JServeEngine(
        ts._jcfg(), jparams, mesh=None, **ts.ENGINE_KW)),
        queue_deadline=0.0).run(reqs)
    one = {r.rid: list(r.tokens) for r in off}
    jeng = JServeEngine(ts._jcfg(), jparams, mesh=None, **SPEC_ENGINE)
    jsched = JServeScheduler(jeng, queue_deadline=0.0)
    jdone = jsched.run([JRequest(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                        for i, p in enumerate(PROMPTS)])
    assert {r.rid: list(r.tokens) for r in jdone} == one
    spec = jsched.stats()["spec"]
    for rank in range(W):
        got = port_world("serve_spec", rank)
        assert {i: got[f"t|{i}"].tolist()
                for i in range(len(PROMPTS))} == one, f"rank {rank}"
        assert int(got["tp"]) == W // 2
        assert int(got["kv_heads"]) == ts.CFG_KW["n_heads"] // (W // 2)
        assert (int(got["proposed"]), int(got["accepted"])) == (
            spec["proposed"], spec["accepted"]), f"rank {rank}"
