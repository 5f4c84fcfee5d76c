#!/usr/bin/env python3
"""Drives the PyTorch port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. setup: the card's name and power limit, the kernels built from the
   sources in ``horovod_tpu_torch/csrc`` (one nvcc per source, started
   together), TF32 off;
2. every kernel against its plain PyTorch version at the slice's shapes,
   timed beside its bound and a library call that computes the same
   function;
3. the slice at full width: the flagship TransformerLM (268M parameters,
   random weights from a seed) served through ``ServeScheduler.run`` —
   the launch counts are zeroed just before and read just after, and the
   kernel is then held against its plain version on the engine's live
   pool;
4. a 2-layer f32 copy of the engine on the card against the same engine
   on the CPU (the plain path): greedy tokens identical, logits within
   1e-4.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the
package, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
LOGIT_TOL = 1e-4


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
# phase 3: the slice at full width
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
    # kernel rows only: an operator's row repeats its kernels' device time
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
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
# phase 4: card against CPU
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa
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
    gen = torch.Generator(device="cuda").manual_seed(0)

    # phase 2: kernel against its plain version at the slice's shapes
    main_case = check_kernel(fa, kvc, gen, kvh=16, dtype=torch.bfloat16,
                             timed=True)
    errs = [main_case["max_abs_err"]]
    errs.append(check_kernel(fa, kvc, gen, kvh=4, dtype=torch.bfloat16,
                             timed=True)["max_abs_err"])
    check_kernel(fa, kvc, gen, kvh=16, dtype=torch.float32, timed=False)

    # phase 3: the slice at full width
    launches, live_err = serve_flagship(htt, fa, kvc, card)
    errs.append(live_err)

    # phase 4: card against CPU
    card_vs_cpu(htt)

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
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
