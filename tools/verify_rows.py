#!/usr/bin/env python3
"""Where the speculative verify step's rows part from the decode step's,
on a GPU.

    python3 tools/verify_rows.py [--rid N] [--trials T]

Prints one JSON line (``verify rows: {...}``):

- ``norm_mean``: the RMS norm's row mean (f32) and the whole norm (bf16)
  of 8 rows alone against the same 8 rows among 16-64 rows, over
  ``trials`` random draws a row count: how many were bitwise equal. The
  reduction's layout follows the row count, so a row's mean can round
  otherwise beside more rows.
- ``replay``: the flagship (random weights, seed 0) and request ``rid``
  of phase 3's traffic, teacher-forced on its own greedy tokens: at each
  position one verify step (K = 4, the drafts the request's next tokens)
  and one decode step, compared on the verify's row 0. Done with the
  verify body's GEMMs and norm means whole (``rows=None``, as before the
  repair) and in chunks of ``slots`` rows (``rows=8``, as ``spec_step``
  runs it): the positions whose logits differ, and at the first, the
  first sub-result of the body (layer, operation) that differs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

K = 4


def norm_mean_trials(trials: int) -> dict:
    from horovod_tpu_torch.models import transformer as tfm
    g = torch.Generator(device="cuda").manual_seed(1)
    scale = torch.randn(1024, generator=g, device="cuda")
    out = {"trials": 0, "mean_bitwise": 0, "norm_bitwise": 0,
           "row_counts": [16, 24, 32, 40, 64]}
    for t in range(trials):
        for rows in out["row_counts"]:
            x = (torch.randn((rows, 1024), generator=g, device="cuda")
                 * (0.1 + t % 7)).to(torch.bfloat16)
            out["mean_bitwise"] += bool(torch.equal(
                (x[:8].float() ** 2).mean(-1), (x.float() ** 2).mean(-1)[:8]))
            out["norm_bitwise"] += bool(torch.equal(
                tfm._rmsnorm(x[:8], scale), tfm._rmsnorm(x, scale)[:8]))
            out["trials"] += 1
    return out


def body_record(eng, bt, ln, toks, rows, row):
    """``serving.engine._decode_body`` with the sub-results of ``row``
    recorded: [(operation, layer, f32 values)]."""
    from horovod_tpu_torch.parallel import tensor_parallel as tp_lib
    from horovod_tpu_torch.serving import engine as E
    from horovod_tpu_torch.serving import kv_cache as kvc
    cfg, p = eng.cfg, eng.params
    rec = []

    def keep(name, layer, t):
        rec.append((name, layer, t[row].float().clone()))

    x = tp_lib.vocab_parallel_embed(toks, p["embed"], None)
    valid = ln < bt.shape[1] * eng.k_pages.shape[2]
    for i in range(cfg.n_layers):
        lp = E._layer(p, i)
        kp, vp = eng.k_pages[i], eng.v_pages[i]
        h = E._norm(x, lp["attn_norm"], rows)
        keep("attn_norm", i, h)
        q, k, v = E._qkv(cfg, lp, h, rows)
        for name, t in (("q", q), ("k", k), ("v", v)):
            keep(name, i, t)
        q, k = E._rope_rows(q, ln), E._rope_rows(k, ln)
        kvc.write_token_kv(kp, vp, k, v, bt, ln, valid=valid)
        o = kvc.paged_decode_attention(q, kp, vp, bt, ln + 1,
                                       cfg.head_dim ** -0.5)
        keep("attention", i, o)
        o = o.to(x.dtype).reshape(x.shape[0], -1)
        o = E._by_rows(lambda t: tp_lib.row_parallel(t, lp["wo"], None),
                       o, rows)
        keep("o_projection", i, o)
        x = x + o.to(x.dtype)
        m = E._mlp(cfg, lp, x, rows)
        keep("mlp", i, m)
        x = x + m.to(x.dtype)
    x = E._norm(x, p["final_norm"], rows)
    keep("logits", -1, E._by_rows(
        lambda t: E._gather_logits(cfg, t, p["head"]), x, rows))
    return rec


def verify_inputs(eng, slot, tokens):
    """The verify step's block tables, lengths and tokens for ``slot``
    alone active, as ``ServeEngine.spec_step`` builds them."""
    s = eng.slots
    bt = np.repeat(eng.tables.tables, K + 1, axis=0)
    ln = (np.repeat(eng.tables.lengths, K + 1)
          + np.tile(np.arange(K + 1, dtype=np.int32), s))
    tv = np.zeros(s * (K + 1), np.int32)
    tv[slot * (K + 1):(slot + 1) * (K + 1)] = tokens
    active = np.zeros(s * (K + 1), bool)
    active[slot * (K + 1):(slot + 1) * (K + 1)] = True
    bt[~active] = eng.pool.scratch_page
    ln[~active] = 0
    return (eng._tensor(bt), eng._tensor(ln.astype(np.int32)),
            eng._tensor(tv))


def decode_inputs(eng, slot, token):
    bt = eng.tables.tables.copy()
    ln = eng.tables.lengths.copy()
    off = np.ones(eng.slots, bool)
    off[slot] = False
    bt[off] = eng.pool.scratch_page
    ln[off] = 0
    t = np.zeros(eng.slots, np.int32)
    t[slot] = token
    return (eng._tensor(bt), eng._tensor(ln.astype(np.int32)),
            eng._tensor(t))


def replay(cfg, params, prompt, toks, rows) -> dict:
    """Teacher-forced verify and decode steps over ``toks``: the positions
    whose verify row 0 differs from the decode row, and the first
    differing sub-result at the first of them."""
    from horovod_tpu_torch.serving import ServeEngine
    plain = ServeEngine(cfg, params, device="cuda")
    spec = ServeEngine(cfg, params, device="cuda", draft="ngram:3",
                       spec_k=K)
    sp, ss = plain.reserve(prompt.size + 40), spec.reserve(prompt.size + 40)
    plain.prefill(sp, prompt)
    spec.prefill(ss, prompt)
    differ, first_op = [], None
    for pos in range(len(toks) - K):
        v = body_record(spec, *verify_inputs(spec, ss, toks[pos:pos + K + 1]),
                        rows, ss * (K + 1))
        d = body_record(plain, *decode_inputs(plain, sp, toks[pos]), None, sp)
        spec.tables.lengths[ss] += 1      # row 0 accepted, drafts dropped
        plain.tables.lengths[sp] += 1
        if torch.equal(v[-1][2], d[-1][2]):
            continue
        differ.append(pos + 1)            # the token index row 0 predicts
        if first_op is None:
            name, layer, _ = next(
                (a for a, b in zip(v, d) if not torch.equal(a[2], b[2])))
            first_op = {"token": pos + 1, "operation": name, "layer": layer,
                        "max_abs_diff": max(
                            float((a[2] - b[2]).abs().max())
                            for a, b in zip(v, d) if a[:2] == (name, layer))}
    del plain, spec
    torch.cuda.empty_cache()
    return {"rows": rows, "tokens_compared": len(toks) - K,
            "tokens_differ": differ, "first_difference": first_op}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rid", type=int, default=11)
    ap.add_argument("--trials", type=int, default=400)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("verify_rows: needs a GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.serving import ServeEngine, ServeScheduler
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cs.flagship_cfg(htt.TransformerConfig)
    params = htt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    req = next(r for r in cs.mp_serve_requests(cfg.vocab_size)
               if r.rid == args.rid)
    prompt = req.prompt.copy()
    eng = ServeEngine(cfg, params, device="cuda")
    toks = list(ServeScheduler(eng, device="cuda").run([req])[0].tokens)
    del eng
    with torch.inference_mode():
        out = {"card": cs.card_line(), "rid": args.rid,
               "prompt_tokens": int(prompt.size),
               "norm_mean": norm_mean_trials(args.trials),
               "replay": [replay(cfg, params, prompt, toks, rows)
                          for rows in (None, 8)]}
    print("verify rows: " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
