#!/usr/bin/env python3
"""Drives the PyTorch port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # one card
    python3 chip_smoke.py --data-parallel 4    # the training step on 4 cards

Phases, each of which raises (and so exits non-zero) when it fails:

1. setup: the card's name and power limit, the kernels built from the
   sources in ``horovod_tpu_torch/csrc`` (one nvcc per source, started
   together), TF32 off;
2. every kernel against its plain PyTorch version at its path's shapes,
   timed beside its bound and a library call that computes the same
   function: the paged-decode kernel (serving), then the flash forward
   and the two flash backward kernels (training: B=8, S=2048, H=16,
   D=64, bf16, causal; plus f32, offset, fully masked and ragged cases);
3. serving at full width: the flagship TransformerLM (268M parameters,
   random weights from a seed) served through ``ServeScheduler.run`` —
   the launch counts are zeroed just before and read just after, and the
   kernel is then held against its plain version on the engine's live
   pool; then a decode profile;
4. training at full width and depth: the flagship as ``bench.py
   transformer`` builds it (batch 8 x 2048, bf16, SGD with momentum),
   one warm-up step and then ``train_loop`` steps through an NCCL world
   of one — launch counts zeroed just before and read just after, losses
   finite, at least 16 launches of each flash kernel per step; then a
   profile of one step;
5. card against CPU: a 2-layer f32 serving engine (greedy tokens
   identical, logits within 1e-4) and a 2-layer f32 training copy (loss,
   every gradient leaf and the parameters after two SGD steps).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the
package, it exits non-zero and prints no result.

``--data-parallel N`` runs only the training step across N cards of one
host: one process per card joins an NCCL world through the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``,
``LOCAL_RANK``), each on its 8 rows of a global batch of 8 N; a world of
one runs first in the same call as the yardstick. It checks that every
rank ends with the same parameters, and prints step ms, tokens/s and the
scaling efficiency against the one-card world.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
LOGIT_TOL = 1e-4
# Flash kernels against their plain versions (which widen the inputs to
# f32), held relative to the largest reference value: the unnormalized
# output and the gradients reach the hundreds at S=2048. f32 runs the FMA
# kernels, which sum in f32 in another order; bf16 runs the tensor-core
# kernels, where P and dS enter their products rounded to bf16 (2^-9).
FLASH_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# Card against CPU in training, f32: sums over 512 tokens and 1024-wide
# products in another order, relative to the leaf's largest value.
GRAD_REL_TOL = 1e-4
PARAM_REL_TOL = 1e-5
TRAIN_B, TRAIN_S = 8, 2048


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call of ``fn(i)`` over ``iters``
    calls, after a warm-up, by CUDA events."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def paged_case(gen, *, b, h, kvh, d, page, n_max, lengths, dtype, copies):
    """``copies`` independent pools (so timed launches rotate through more
    than the 50 MB L2, as the layers of a decode step do), one block-table
    set, ragged lengths."""
    dev = torch.device("cuda")
    n_pages = b * n_max
    shape = (n_pages + 1, page, kvh, d)
    pools = [(torch.randn(shape, generator=gen, device=dev).to(dtype),
              torch.randn(shape, generator=gen, device=dev).to(dtype))
             for _ in range(copies)]
    q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device=dev)
    bt = perm.reshape(b, n_max).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pools, bt, ln


def kernel_bound_ms(q, k_pages, lengths, n_ctx) -> float:
    """Least time for the work: K/V rows read once (only positions below
    each length), q read, the f32 output written — or its f32 operations
    at the card's f32 rate, whichever is larger."""
    b, h, d = q.shape
    kvh = k_pages.shape[2]
    rows = int(lengths.clamp(0, n_ctx).sum())
    nbytes = (2 * rows * kvh * d * k_pages.element_size()
              + q.numel() * q.element_size() + b * h * d * 4
              + 4 * b * (n_ctx // k_pages.shape[1]) + 4 * b)
    flops = 4 * rows * h * d
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3


def check_kernel(fa, kvc, gen, *, kvh, dtype, timed):
    b, h, d, page, n_max = 8, 16, 64, 128, 16
    lengths = [1, 2048, 300, 0, 1024, 1537, 128, 777]     # slot 3 is empty
    copies = 4 if timed else 1
    q, pools, bt, ln = paged_case(gen, b=b, h=h, kvh=kvh, d=d, page=page,
                                  n_max=n_max, lengths=lengths, dtype=dtype,
                                  copies=copies)
    kp, vp = pools[0]
    scale = d ** -0.5
    out = fa.flash_paged_decode(q, kp, vp, bt, ln, scale)
    torch.cuda.synchronize()
    ref = kvc.paged_attention_reference(q, kp, vp, bt, ln, scale)
    err = float((out - ref).abs().max())
    tag = f"paged_decode {str(dtype)[6:]} H={h} KVH={kvh}"
    log(f"{tag}: max_abs_err {err:.3e} (tol {TOL[dtype]:.0e})")
    if not torch.isfinite(out).all() or err > TOL[dtype]:
        raise AssertionError(f"{tag}: kernel disagrees with its plain "
                             f"version: max_abs_err {err}")
    if not bool((out[3] == 0).all()):
        raise AssertionError(f"{tag}: empty slot is not exact zeros")
    res = {"max_abs_err": err}
    if not timed:
        return res
    res["ms"] = cuda_ms(lambda i: fa.flash_paged_decode(
        q, *pools[i % copies], bt, ln, scale), 200)
    res["plain_ms"] = cuda_ms(lambda i: kvc.paged_attention_reference(
        q, *pools[i % copies], bt, ln, scale), 20)
    res["bound_ms"] = kernel_bound_ms(q, kp, ln, n_max * page)
    # yardstick only: one library call over the same pages, gathered
    # beforehand (the port never calls it)
    n_ctx = n_max * page
    gathered = []
    for kpi, vpi in pools:
        kg = kpi[bt.long()].reshape(b, n_ctx, kvh, d).transpose(1, 2)
        vg = vpi[bt.long()].reshape(b, n_ctx, kvh, d).transpose(1, 2)
        gathered.append((kg.repeat_interleave(h // kvh, dim=1).contiguous(),
                         vg.repeat_interleave(h // kvh, dim=1).contiguous()))
    mask = (torch.arange(n_ctx, device=q.device)[None, :]
            < ln.long()[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["library_ms"] = cuda_ms(lambda i: sdpa(
        q4, *gathered[i % copies], attn_mask=mask, scale=scale), 200)
    res["bound_by"] = "bytes"
    log(f"{tag}: kernel {res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms,"
        f" plain {res['plain_ms']:.4f} ms, sdpa {res['library_ms']:.4f} ms")
    return res


# ---------------------------------------------------------------------------
# phase 2: the flash kernels against their plain versions
# ---------------------------------------------------------------------------

def visible_pairs(s_q, s_k, q_offset, k_offset, causal) -> int:
    """(query, key) pairs the causal mask leaves visible for one (b, h)."""
    if not causal:
        return s_q * s_k
    # row i sees keys j <= q_offset + i - k_offset
    rows = torch.arange(s_q, dtype=torch.int64) + q_offset - k_offset + 1
    return int(rows.clamp(0, s_k).sum())


def flash_bounds(q, s_k, q_offset, k_offset, causal):
    """Least time of each kernel at this geometry: inputs read once,
    outputs written once, over the card's memory rate; its matrix
    products over the visible pairs at the inputs' tensor-core rate (bf16)
    or the f32 rate. Returns {kernel: (ms, bound_by)}."""
    b, s_q, h, d = q.shape
    pairs = b * h * visible_pairs(s_q, s_k, q_offset, k_offset, causal)
    rate = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    es = q.element_size()
    q_bytes, kv_bytes = b * s_q * h * d * es, b * s_k * h * d * es
    stats = b * h * s_q * 4
    cases = {
        # s = q k^T and o = p v: 2 products
        "flash_fwd": (q_bytes + 2 * kv_bytes + b * s_q * h * d * 4
                      + 2 * stats, 2 * 2 * d * pairs),
        # s, dp = do v^T, dq = ds k: 3 products; q, do, k, v, lse, dD in
        "flash_bwd_dq": (2 * q_bytes + 2 * kv_bytes + 2 * stats
                         + b * s_q * h * d * 4, 3 * 2 * d * pairs),
        # s, dp, dv = p^T do, dk = ds^T q: 4 products
        "flash_bwd_dkv": (2 * q_bytes + 2 * kv_bytes + 2 * stats
                          + 2 * b * s_k * h * d * 4, 4 * 2 * d * pairs),
    }
    out = {}
    for name, (nbytes, flops) in cases.items():
        t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
        out[name] = (max(t_mem, t_ops) * 1e3,
                     "bytes" if t_mem >= t_ops else "operations")
    return out


def device_rows(prof):
    """(device us, kernel name, calls) of every kernel in a profile, most
    time first. Kernel rows only: an operator's row repeats its kernels'
    device time."""
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def kernel_device_ms(fn, names, iters: int = 5):
    """Device ms per launch of each kernel in ``names`` (a substring of
    its symbol, and of no other kernel's that ``fn`` launches) over
    ``iters`` calls of ``fn``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {name: us / 1e3 / count for us, key, count in device_rows(prof)
           for name in names if name in key}
    missing = [n for n in names if n not in out]
    if missing:
        raise AssertionError(f"profiler saw no device time for {missing}")
    return out


def check_flash(fa, sq, gen, *, b, s_q, s_k, h, d, dtype, q_offset=0,
                k_offset=0, causal=True, timed=False):
    """The three flash kernels against ``_block_attend`` and
    ``_bwd_block_plain`` on the same inputs (widened to f32, as the
    autograd.Function does on the CPU). Returns the largest error of
    each kernel and, when ``timed``, its times and bound."""
    dev = torch.device("cuda")
    q, k, v, do = (torch.randn((b, n, h, d), generator=gen, device=dev
                               ).to(dtype) for n in (s_q, s_k, s_k, s_q))
    scale = d ** -0.5
    tag = (f"flash {str(dtype)[6:]} B={b} Sq={s_q} Sk={s_k} H={h} D={d} "
           f"offsets=({q_offset},{k_offset}) causal={causal}")
    o, m, l = fa.flash_block_attend(q, k, v, q_offset, k_offset, causal,
                                    scale)
    torch.cuda.synchronize()
    ro, rm, rl = sq._block_attend(q.float(), k.float(), v.float(), q_offset,
                                  k_offset, causal, scale)
    l_safe = rl.clamp_min(1e-30)
    lse = rm + torch.log(l_safe)
    o_norm = ro / l_safe.transpose(1, 2)[..., None]
    dD = (do.float() * o_norm).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_bwd_block(q, k, v, do, lse, dD, q_offset, k_offset,
                             causal, scale)
    torch.cuda.synchronize()
    want = sq._bwd_block_plain(q, k, v, do, lse, dD, q_offset, k_offset,
                               causal, scale)
    errs = {}
    for kname, pairs in (("flash_fwd", ((o, ro), (m, rm), (l, rl))),
                         ("flash_bwd_dq", ((got[0], want[0]),)),
                         ("flash_bwd_dkv", ((got[1], want[1]),
                                           (got[2], want[2])))):
        err = 0.0
        for a, ref in pairs:
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{tag}: {kname} gave non-finite "
                                     f"values")
            e = float((a - ref).abs().max())
            lim = FLASH_REL_TOL[dtype] * max(1.0, float(ref.abs().max()))
            if e > lim:
                raise AssertionError(f"{tag}: {kname} disagrees with its "
                                     f"plain version: {e} > {lim}")
            err = max(err, e)
        errs[kname] = err
    masked = rm <= sq.NEG_INF / 2                      # rows that see no key
    if bool(masked.any()):
        rows = masked.transpose(1, 2)                  # [B, Sq, H]
        if not (bool((m[masked] == sq.NEG_INF).all())
                and bool((l[masked] == 0).all())
                and bool((o[rows] == 0).all())
                and bool((got[0][rows] == 0).all())):
            raise AssertionError(f"{tag}: a fully masked row is not "
                                 f"exactly m=-1e30, l=0, o=0, dq=0")
    log(f"{tag}: max_abs_err " + json.dumps(
        {k_: float(f"{e_:.3e}") for k_, e_ in errs.items()})
        + f", {int(masked.sum())} fully masked rows")
    res = {"max_abs_err": errs}
    if not timed:
        return res
    args = (q_offset, k_offset, causal, scale)
    res["ms"] = kernel_device_ms(
        lambda: (fa.flash_block_attend(q, k, v, *args),
                 fa.flash_bwd_block(q, k, v, do, lse, dD, *args)),
        ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
    res["plain_fwd_ms"] = cuda_ms(lambda i: sq._block_attend(
        q.float(), k.float(), v.float(), *args), 3)
    res["plain_bwd_ms"] = cuda_ms(lambda i: sq._bwd_block_plain(
        q, k, v, do, lse, dD, *args), 3)
    res["bounds"] = flash_bounds(q, s_k, q_offset, k_offset, causal)
    # yardstick only (the port never calls it): one library call for the
    # same function on pre-transposed [B, H, S, D] tensors
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    res["library_fwd_ms"] = cuda_ms(lambda i: sdpa(
        qt, kt, vt, is_causal=causal, scale=scale), 20)

    def fwd_bwd(i):
        out = sdpa(qt, kt, vt, is_causal=causal, scale=scale)
        torch.autograd.grad(out, (qt, kt, vt), dot)

    res["library_bwd_ms"] = cuda_ms(fwd_bwd, 20) - res["library_fwd_ms"]
    log(f"{tag}: kernels " + json.dumps(
        {k_: round(v_, 4) for k_, v_ in res["ms"].items()})
        + f" ms; plain fwd {res['plain_fwd_ms']:.3f} ms, bwd "
        f"{res['plain_bwd_ms']:.3f} ms; sdpa fwd "
        f"{res['library_fwd_ms']:.4f} ms, bwd {res['library_bwd_ms']:.4f}"
        f" ms; bounds " + json.dumps(res["bounds"]))
    return res


def check_flash_all(fa, sq, gen):
    """Every case of the flash kernel phase; returns the timed main case
    and the largest error of each kernel over all cases."""
    train = dict(b=TRAIN_B, h=16, d=64)
    main_case = check_flash(fa, sq, gen, s_q=TRAIN_S, s_k=TRAIN_S,
                            dtype=torch.bfloat16, timed=True, **train)
    cases = [main_case["max_abs_err"]]
    cases.append(check_flash(fa, sq, gen, b=2, s_q=2048, s_k=2048, h=16,
                             d=64, dtype=torch.float32)["max_abs_err"])
    for causal in (False, True):
        cases.append(check_flash(fa, sq, gen, s_q=1024, s_k=1024,
                                 dtype=torch.bfloat16, q_offset=2048,
                                 k_offset=0, causal=causal,
                                 **train)["max_abs_err"])
    cases.append(check_flash(fa, sq, gen, b=2, s_q=1024, s_k=1024, h=16,
                             d=64, dtype=torch.bfloat16, q_offset=0,
                             k_offset=1024)["max_abs_err"])  # all masked
    cases.append(check_flash(fa, sq, gen, b=2, s_q=1000, s_k=1000, h=16,
                             d=64, dtype=torch.bfloat16)["max_abs_err"])
    worst = {k_: max(c[k_] for c in cases) for k_ in cases[0]}
    return main_case, worst


# ---------------------------------------------------------------------------
# phase 3: serving at full width
# ---------------------------------------------------------------------------

def flagship_cfg(TransformerConfig, **kw):
    """bench.py's flagship transformer: 268M parameters."""
    base = dict(vocab_size=32768, d_model=1024, n_heads=16, head_dim=64,
                n_layers=16, d_ff=4096, max_seq=2048, dtype=torch.bfloat16,
                dp_axis=None, remat=False)
    base.update(kw)
    return TransformerConfig(**base)


def pct(xs, p) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), p))


def serve_flagship(htt, fa, kvc, card):
    from horovod_tpu_torch.serving import Request, ServeEngine, ServeScheduler
    cfg = flagship_cfg(htt.TransformerConfig)
    params = htt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        t.numel() for k, t in params.items() if k != "layers")
    eng = ServeEngine(cfg, params, device="cuda")
    rng = np.random.default_rng(0)
    warm = [Request(rid=100 + i, prompt=rng.integers(
        0, cfg.vocab_size, 40).astype(np.int32), max_new_tokens=4)
        for i in range(2)]
    ServeScheduler(eng, device="cuda").run(warm)
    torch.cuda.synchronize()

    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, int(rng.integers(64, 1025))).astype(np.int32),
        max_new_tokens=32) for i in range(16)]
    sched = ServeScheduler(eng, mode="continuous", device="cuda")
    fa.reset_launches()
    t0 = time.perf_counter()
    done = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    st = sched.stats()
    steps = st["decode_steps"]
    if len(done) != 16 or any(r.error or len(r.tokens) != 32 for r in done):
        raise AssertionError("not every request completed with 32 tokens")
    if any(not (0 <= t < cfg.vocab_size) for r in done for t in r.tokens):
        raise AssertionError("token out of the vocabulary")
    if not torch.isfinite(eng.last_logits).all():
        raise AssertionError("non-finite logits")
    if launches["paged_decode"] < cfg.n_layers * steps or steps == 0:
        raise AssertionError(
            f"paged_decode launched {launches['paged_decode']} times over "
            f"{steps} decode steps of {cfg.n_layers} layers")
    gen_tokens = st["generated_tokens"]
    ttft = [r.ttft * 1e3 for r in done]
    tpot = [t * 1e3 for r in done for t in r.tpot]
    serve = {
        "model": "flagship TransformerLM", "params": n_params,
        "requests": len(done), "prompt_tokens": int(sum(
            r.prompt.size for r in done)), "generated_tokens": gen_tokens,
        "decode_steps": steps, "mean_occupancy": st["mean_occupancy"],
        "wall_s": wall, "tokens_per_s": gen_tokens / wall,
        "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
        "tpot_ms_p50": pct(tpot, 50), "tpot_ms_p99": pct(tpot, 99),
        "paged_decode_launches": launches["paged_decode"],
        "card": card}
    log("serve: " + json.dumps(serve))

    # the kernel on the engine's live pool: 7 slots prefilled to ragged
    # lengths, slot 7 left empty (scratch block table, length 0)
    prompts = [1, 130, 257, 513, 700, 1024, 2000]
    for n in prompts:
        slot = eng.reserve(n + 1)
        eng.prefill(slot, rng.integers(0, cfg.vocab_size, n).astype(
            np.int32))
    eng.decode_step(np.zeros((eng.slots,), np.int32))
    bt, ln = eng.tables.device_views(eng.device)
    q = torch.randn((eng.slots, cfg.n_heads, cfg.head_dim), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5)
                    ).to(cfg.dtype)
    err = 0.0
    for layer in (0, cfg.n_layers - 1):
        kp, vp = eng.k_pages[layer], eng.v_pages[layer]
        out = fa.flash_paged_decode(q, kp, vp, bt, ln, cfg.head_dim ** -0.5)
        ref = kvc.paged_attention_reference(q, kp, vp, bt, ln,
                                            cfg.head_dim ** -0.5)
        e = float((out - ref).abs().max())
        if e > TOL[cfg.dtype] or not bool((out[7] == 0).all()):
            raise AssertionError(f"live pool layer {layer}: kernel "
                                 f"disagrees (max_abs_err {e})")
        err = max(err, e)
    log(f"live pool (lengths {ln.tolist()}): max_abs_err {err:.3e}")
    profile_decode(eng, card)
    for slot in range(eng.slots):
        eng.release(slot)
    return launches, err


def profile_decode(eng, card, n_steps: int = 8) -> None:
    """Where a decode step's time goes: host wall time per step, device
    busy share (summed kernel time over the window) and the kernels that
    take most device time, from torch.profiler over ``n_steps`` steps of
    the engine as it stands (7 active slots)."""
    from torch.profiler import ProfilerActivity, profile
    tokens = np.zeros((eng.slots,), np.int32)
    eng.decode_step(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.decode_step(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    dev_ms = sum(r[0] for r in rows) / 1e3
    out = {"steps": n_steps, "wall_ms_per_step": wall_ms / n_steps,
           "device_ms_per_step": (dev_ms / n_steps) if rows else None,
           "device_busy_share": (dev_ms / wall_ms) if rows else None,
           "top_device_ops": [
               {"op": k[:60], "ms_per_step": us / 1e3 / n_steps,
                "calls_per_step": c / n_steps} for us, k, c in rows[:8]],
           "card": card}
    log("decode profile: " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 4: training at full width and depth
# ---------------------------------------------------------------------------

def model_flops_per_token(cfg, seq: int) -> float:
    """bench.py's MFU convention: 6 x parameters per token for the dense
    path plus 6 x L x S x d_attn for causal attention (recompute not
    counted)."""
    d_attn = cfg.n_heads * cfg.head_dim
    n_params = (cfg.vocab_size * cfg.d_model
                + cfg.n_layers * (4 * cfg.d_model * d_attn
                                  + 2 * cfg.d_model * cfg.d_ff
                                  + 2 * cfg.d_model)
                + cfg.d_model + cfg.d_model * cfg.vocab_size)
    return 6 * n_params + 6 * cfg.n_layers * seq * d_attn


def train_flagship(htt, fa, card, n_steps: int = 4):
    """The training main path: ``runtime.init()`` forms an NCCL world of
    one, then ``make_transformer_train_step`` + ``train_loop`` over
    ``n_steps`` batches after one warm-up step."""
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    ctx = htt.init()
    if ctx.backend != "nccl" or htt.size() != 1:
        raise AssertionError(f"expected an NCCL world of one, got "
                             f"{ctx.backend} x {htt.size()}")
    params = htt.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    init_fn, step = htt.make_transformer_train_step(
        cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
        device="cuda")
    state = init_fn(params)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [tuple(torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                                   generator=gen, device="cuda")
                     for _ in range(2)) for _ in range(n_steps + 1)]
    state, loss = step(state, *batches[0])                  # warm-up
    torch.cuda.synchronize()
    warm_loss = float(loss)

    losses, stamps = [], []

    def on_step(i, st, loss_t):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss_t))

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    state, info = htt.train_loop(step, state, batches[1:], on_step=on_step)
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if info["final_step"] != n_steps + 1 or info["status"] != "completed":
        raise AssertionError(f"train_loop info {info}")
    if not all(np.isfinite(x) for x in [warm_loss] + losses):
        raise AssertionError(f"non-finite loss: {[warm_loss] + losses}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches[name] < cfg.n_layers * n_steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times over {n_steps} "
                f"steps of {cfg.n_layers} layers")
    step_s = np.diff([t0] + stamps)
    tokens = TRAIN_B * TRAIN_S
    mean_s = float(step_s.mean())
    flops_tok = model_flops_per_token(cfg, TRAIN_S)
    train = {
        "model": "flagship TransformerLM", "batch": TRAIN_B,
        "seq": TRAIN_S, "steps": n_steps, "warm_loss": warm_loss,
        "losses": losses, "step_ms": [float(x) * 1e3 for x in step_s],
        "step_ms_mean": mean_s * 1e3, "tokens_per_s": tokens / mean_s,
        "mfu": tokens / mean_s * flops_tok / BF16_FLOPS_PER_S,
        "peak_memory_gb": peak_gb,
        "launches": {k_: launches[k_] for k_ in
                     ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
        "card": card}
    log("train: " + json.dumps(train))
    profile_train_step(step, state, batches[-1], card)
    htt.shutdown()
    return launches


def profile_train_step(step, state, batch, card) -> None:
    """Where a training step's time goes: host wall ms, device ms (kernel
    rows only), busy share, and the top device ops, from torch.profiler
    over one step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof)
    dev_ms = sum(r[0] for r in rows) / 1e3
    out = {"wall_ms": wall_ms,
           "device_ms": dev_ms if rows else None,
           "device_busy_share": (dev_ms / wall_ms) if rows else None,
           "top_device_ops": [{"op": k_[:70], "ms": us / 1e3, "calls": c}
                              for us, k_, c in rows[:8]],
           "card": card}
    log("train profile: " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 5: card against CPU
# ---------------------------------------------------------------------------

def card_vs_cpu(htt):
    from horovod_tpu_torch.serving import ServeEngine
    cfg = flagship_cfg(htt.TransformerConfig, n_layers=2,
                       dtype=torch.float32)
    cpu_params = htt.init_params(cfg, torch.Generator().manual_seed(1),
                                 device="cpu")
    gpu_params = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cuda())
                  for k, v in cpu_params.items()}
    engines = [ServeEngine(cfg, cpu_params, device="cpu"),
               ServeEngine(cfg, gpu_params, device="cuda")]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (37, 300, 129)]
    worst = 0.0

    def compare(what, toks):
        nonlocal worst
        a, b = (e.last_logits.float().cpu() for e in engines)
        err = float((a - b).abs().max())
        worst = max(worst, err)
        if toks[0] != toks[1] or err > LOGIT_TOL:
            raise AssertionError(f"{what}: card and CPU differ (tokens "
                                 f"{toks}, max logit diff {err})")

    last = []
    for p in prompts:
        slots = [e.reserve(p.size + 8) for e in engines]
        toks = [e.prefill(s, p) for e, s in zip(engines, slots)]
        compare(f"prefill of {p.size} tokens", toks)
        last.append(toks[0])
    active = np.zeros((engines[0].slots,), bool)
    active[:len(prompts)] = True
    for step in range(6):
        tokens = np.zeros((engines[0].slots,), np.int32)
        tokens[:len(prompts)] = last
        outs = [e.decode_step(tokens, active=active) for e in engines]
        toks = [o[active].tolist() for o in outs]
        compare(f"decode step {step}", toks)
        last = toks[0]
    log(f"card vs cpu (2-layer f32 flagship width): tokens identical, "
        f"max logit diff {worst:.3e} (tol {LOGIT_TOL:.0e})")


def train_card_vs_cpu(htt) -> None:
    """A 2-layer f32 copy of the flagship at full width, the same numpy
    parameters and batch on the CPU and on the card: the loss and every
    gradient leaf, then the parameters after two SGD steps (no collective:
    dp_axis=None)."""
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.utils import tree as tree_util
    cfg = flagship_cfg(htt.TransformerConfig, n_layers=2,
                       dtype=torch.float32, mlp_recompute=True)
    np_params = tree_util.tree_map(
        lambda t: t.numpy(),
        htt.init_params(cfg, torch.Generator().manual_seed(3),
                        device="cpu"))
    rng = np.random.default_rng(4)
    tokens, labels = (torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 256))) for _ in range(2))
    runs = {}
    for dev in ("cpu", "cuda"):
        params = htt.params_from_numpy(np_params, device=dev)
        leaves = tree_util.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = tfm.loss_fn(cfg, params, tokens.to(dev), labels.to(dev))
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        loss = loss.detach()
        init_fn, step = htt.make_transformer_train_step(
            cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
            device=dev)
        state = init_fn(htt.params_from_numpy(np_params, device=dev))
        for _ in range(2):
            state, _ = step(state, tokens, labels)
        runs[dev] = (loss.item(), grads,
                     [t.detach().cpu() for t in
                      tree_util.tree_leaves(state.params)])

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    (l_cpu, g_cpu, p_cpu), (l_gpu, g_gpu, p_gpu) = runs["cpu"], runs["cuda"]
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_rel = max(rel(a, b) for a, b in zip(g_gpu, g_cpu))
    param_rel = max(rel(a, b) for a, b in zip(p_gpu, p_cpu))
    log(f"train card vs cpu (2-layer f32 flagship width, B=2 S=256): loss "
        f"{l_gpu:.6f} vs {l_cpu:.6f} (rel {loss_rel:.2e}), worst gradient "
        f"leaf rel {grad_rel:.2e} (tol {GRAD_REL_TOL:.0e}), params after "
        f"2 SGD steps rel {param_rel:.2e} (tol {PARAM_REL_TOL:.0e})")
    if not (loss_rel <= PARAM_REL_TOL and grad_rel <= GRAD_REL_TOL
            and param_rel <= PARAM_REL_TOL):
        raise AssertionError("training on the card and on the CPU differ")


# ---------------------------------------------------------------------------
# --data-parallel N: the training step across N cards
# ---------------------------------------------------------------------------

def dp_rank(rank, world, port, results, device="cuda", cfg_kw=None,
            n_steps=4):
    """One rank of an N-card world: trains the flagship (or ``cfg_kw``) on
    its rows of each global batch; rank 0 puts the world's numbers on
    ``results``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.utils import tree as tree_util
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = htt.init(device=device)
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp", **(cfg_kw or {}))
    dev = ctx.device
    # each rank starts from other weights: init_fn broadcasts rank 0's
    params = htt.init_params(
        cfg, torch.Generator(device=dev).manual_seed(rank), device=dev)
    init_fn, step = htt.make_transformer_train_step(
        cfg, lambda ps: torch.optim.SGD(ps, lr=0.01, momentum=0.9),
        device=dev)
    state = init_fn(params)
    b, s = TRAIN_B, TRAIN_S
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = slice(rank * b, (rank + 1) * b)
    batches = [tuple(torch.randint(0, cfg.vocab_size, (b * world, s),
                                   generator=gen, device=dev)[rows]
                     for _ in range(2)) for _ in range(n_steps + 1)]
    state, _ = step(state, *batches[0])                    # warm-up
    losses, stamps = [], []
    htt.barrier()
    t0 = time.perf_counter()
    for batch in batches[1:]:
        state, loss = step(state, *batch)
        losses.append(float(loss))                          # synchronizes
        stamps.append(time.perf_counter())
    total = sum(float(t.detach().double().sum())
                for t in tree_util.tree_leaves(state.params))
    lo = htt.allreduce(torch.tensor([total], dtype=torch.float64,
                                    device=dev), htt.Min)
    hi = htt.allreduce(torch.tensor([total], dtype=torch.float64,
                                    device=dev), htt.Max)
    if rank == 0:
        step_s = np.diff([t0] + stamps)
        results.put({"world": world, "losses": losses,
                     "step_ms": [float(x) * 1e3 for x in step_s],
                     "step_ms_mean": float(step_s.mean()) * 1e3,
                     "tokens_per_s": b * s * world / float(step_s.mean()),
                     "params_equal_across_ranks": float(lo) == float(hi)})
    htt.shutdown()


def run_world(world, **kw):
    """``dp_rank`` in ``world`` spawned processes; rank 0's results."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [ctx.Process(target=dp_rank, args=(r, world, port, results),
                         kwargs=kw) for r in range(world)]
    for p in procs:
        p.start()
    out = results.get(timeout=600)          # drained before the join
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"a rank of the {world}-card world failed: "
                             f"{[p.exitcode for p in procs]}")
    return out


def data_parallel(n: int, card: str, **kw) -> None:
    one = run_world(1, **kw)
    many = run_world(n, **kw)
    for res in (one, many):
        if not (res["params_equal_across_ranks"]
                and all(np.isfinite(x) for x in res["losses"])):
            raise AssertionError(f"data-parallel run failed: {res}")
    many["scaling_efficiency"] = many["tokens_per_s"] / (
        n * one["tokens_per_s"])
    log("data parallel: " + json.dumps({"one_card": one, "n_cards": many,
                                         "card": card}))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    n_dp = 0
    if argv:
        if len(argv) != 2 or argv[0] != "--data-parallel":
            print("usage: chip_smoke.py [--data-parallel N]", file=sys.stderr)
            return 2
        n_dp = int(argv[1])
        if not 2 <= n_dp <= torch.cuda.device_count():
            print(f"chip_smoke: --data-parallel {n_dp} needs 2..."
                  f"{torch.cuda.device_count()} cards", file=sys.stderr)
            return 2
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import sequence as sq
    from horovod_tpu_torch.serving import kv_cache as kvc

    # phase 1: setup
    card = card_line()
    log(card)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    seconds = _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s: "
        + json.dumps({k: round(v, 2) for k, v in seconds.items()}))
    for name, text in _build.build_logs.items():
        for line in text.strip().splitlines():
            log(f"  [{name}] {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if n_dp:
        data_parallel(n_dp, card)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    gen = torch.Generator(device="cuda").manual_seed(0)

    # phase 2: every kernel against its plain version
    main_case = check_kernel(fa, kvc, gen, kvh=16, dtype=torch.bfloat16,
                             timed=True)
    errs = [main_case["max_abs_err"]]
    errs.append(check_kernel(fa, kvc, gen, kvh=4, dtype=torch.bfloat16,
                             timed=True)["max_abs_err"])
    check_kernel(fa, kvc, gen, kvh=16, dtype=torch.float32, timed=False)
    flash_case, flash_errs = check_flash_all(fa, sq, gen)

    # phase 3: serving at full width
    launches, live_err = serve_flagship(htt, fa, kvc, card)
    errs.append(live_err)

    # phase 4: training at full width and depth
    train_launches = train_flagship(htt, fa, card)

    # phase 5: card against CPU
    card_vs_cpu(htt)
    train_card_vs_cpu(htt)

    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "horovod_tpu_torch/csrc/paged_decode.cu",
        "replaces": "horovod_tpu/ops/pallas/flash_attention.py:498",
        "launches": launches["paged_decode"],
        "max_abs_err": max(errs),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"]}]
    # The plain backward computes dq, dk and dv in one function, and one
    # library backward computes all three: both times stand for the pair
    # (the library's on the dq row only).
    flash_rows = (
        ("flash_fwd", "flash_fwd.cu", 86, flash_case["plain_fwd_ms"],
         flash_case["library_fwd_ms"]),
        ("flash_bwd_dq", "flash_bwd.cu", 239, flash_case["plain_bwd_ms"],
         flash_case["library_bwd_ms"]),
        ("flash_bwd_dkv", "flash_bwd.cu", 285, flash_case["plain_bwd_ms"],
         None))
    for name, src, line, plain_ms, lib_ms in flash_rows:
        bound_ms, bound_by = flash_case["bounds"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{src}",
            "replaces": f"horovod_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": flash_errs[name],
            "ms": flash_case["ms"][name], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
