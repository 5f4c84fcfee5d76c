"""Ring and Ulysses attention of the port against the JAX package's, on
the CPU.

One 4-rank gloo world on an (sp 4) mesh (``test_torch_workers.
run_phases``): each rank takes its sequence block of the same global q,
k, v and output cotangent and runs ``ring_attention`` or
``ulysses_attention`` with ``sp`` bound; the blocks of its output and of
the q/k/v gradients are held against the JAX functions under
``shard_map`` on ``jax.devices()[:4]``, causal and not, at local lengths
that are not a multiple of 64 (24 and 80). Then, in one process, the
ring's per-step bodies (``ring_fwd_step``, ``ring_bwd_step``) over four
virtual ring positions against ``local_attention`` and its autograd over
the whole sequence: the check ``chip_smoke.py`` makes with the kernels.
f32 throughout; limits 2e-5 (the softmax is merged in a different
order).
"""

import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

from horovod_tpu.eager import shard_map
from horovod_tpu.parallel import sequence as jsq
from horovod_tpu_torch.parallel import sequence as sq
import test_torch_workers as workers

LIMIT_S = 90
TOL = dict(atol=2e-5, rtol=2e-5)
W = 4
CASES = {f"{impl}_{'causal' if causal else 'full'}_{s}":
         dict(impl=impl, causal=causal, s_local=s)
         for impl in ("ring", "ulysses") for causal in (True, False)
         for s in (24, 80)}


@pytest.fixture(scope="module", autouse=True)
def _limit():
    def expired(*_):
        raise TimeoutError(f"{__name__} ran past its {LIMIT_S} s limit")
    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


def _inputs(s_local, seed, b=2, h=4, d=16):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(b, W * s_local, h, d).astype(np.float32)
            for n in ("q", "k", "v", "do")}


def _case_inputs():
    return {tag: dict(tag=tag, impl=c["impl"], causal=c["causal"],
                      **_inputs(c["s_local"], i))
            for i, (tag, c) in enumerate(sorted(CASES.items()))}


INPUTS = _case_inputs()


@pytest.fixture(scope="module")
def port_world(tmp_path_factory):
    phases = [dict(init=dict(mesh_shape=(W,), axis_names=("sp",)),
                   scenarios=[dict(name="attn", kind="attention",
                                   cases=list(INPUTS.values()))])]
    load = workers.run_phases(W, phases, tmp_path_factory.mktemp("seq"))
    yield load
    if not load.joined:
        workers.join_world(load.procs)


def _jax_attention(case):
    fn = {"ring": jsq.ring_attention, "ulysses": jsq.ulysses_attention}[
        case["impl"]]
    mesh = Mesh(np.array(jax.devices()[:W]), ("sp",))
    spec = JP(None, "sp")

    def local(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, "sp",
                                            causal=case["causal"]),
                         q, k, v)
        return (o,) + vjp(do)

    return jax.jit(shard_map(local, mesh, in_specs=(spec,) * 4,
                             out_specs=(spec,) * 4))(
        *(jnp.asarray(case[n]) for n in ("q", "k", "v", "do")))


@pytest.mark.parametrize("tag", sorted(CASES))
def test_attention_and_gradients_match_jax(port_world, tag):
    want = _jax_attention(INPUTS[tag])
    outs = [port_world("attn", r) for r in range(W)]
    for name, w in zip(("o", "dq", "dk", "dv"), want):
        got = np.concatenate([o[f"{tag}|{name}"] for o in outs], axis=1)
        np.testing.assert_allclose(got, np.asarray(w), **TOL,
                                   err_msg=f"{tag} {name}")


@pytest.mark.parametrize("causal", [True, False])
def test_ring_step_bodies_over_virtual_positions_match_flash(causal):
    """The ring's per-step bodies at four virtual positions, assembled,
    equal attention over the whole sequence and its gradients."""
    inp = _inputs(24, 9)
    q, k, v, do = (torch.from_numpy(inp[n]) for n in ("q", "k", "v", "do"))
    n, s = W, q.shape[1] // W
    scale = q.shape[-1] ** -0.5
    blocks = [slice(i * s, (i + 1) * s) for i in range(n)]
    outs, lses = [], []
    for my in range(n):
        qb = q[:, blocks[my]].contiguous()
        acc = torch.zeros(qb.shape)
        m = torch.full(qb.shape[:3], float("-inf"))
        l = torch.zeros(qb.shape[:3])
        for t in range(n):
            src = (my - t) % n
            acc, m, l = sq.ring_fwd_step(
                qb, k[:, blocks[src]].contiguous(),
                v[:, blocks[src]].contiguous(), my * s, src * s, causal,
                scale, acc, m, l)
        outs.append(acc / l.clamp_min(1e-30)[..., None])
        lses.append((m + torch.log(l.clamp_min(1e-30))).transpose(1, 2))
    o = torch.cat(outs, dim=1)
    dq = torch.zeros(q.shape)
    dkv = torch.zeros((2,) + k.shape)
    for my in range(n):
        qb, dob = q[:, blocks[my]].contiguous(), do[:, blocks[my]]
        dD = (dob * o[:, blocks[my]]).sum(-1).transpose(1, 2)
        dqb = torch.zeros(qb.shape)
        for src in range(n):
            acc = torch.zeros((2,) + k[:, blocks[src]].shape)
            sq.ring_bwd_step(qb, k[:, blocks[src]].contiguous(),
                             v[:, blocks[src]].contiguous(), dob.contiguous(),
                             lses[my].contiguous(), dD.contiguous(), my * s,
                             src * s, causal, scale, dqb, acc)
            dkv[:, :, blocks[src]] += acc
        dq[:, blocks[my]] = dqb
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    ref = sq.local_attention(qg, kg, vg, causal)
    rq, rk, rv = torch.autograd.grad((ref * do).sum(), (qg, kg, vg))
    torch.testing.assert_close(o, ref.detach(), **TOL)
    torch.testing.assert_close(dq, rq, **TOL)
    torch.testing.assert_close(dkv[0], rk, **TOL)
    torch.testing.assert_close(dkv[1], rv, **TOL)
