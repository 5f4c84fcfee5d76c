#!/usr/bin/env python3
"""Drives the PyTorch port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                      # one card
    python3 chip_smoke.py --data-parallel 4    # collectives and training on 4 cards

Phases, each of which raises (and so exits non-zero) when it fails:

1. setup: the card's name and power limit, the kernels built from the
   sources in ``horovod_tpu_torch/csrc`` (one nvcc per source, started
   together) with each build's ``ptxas -v`` lines (registers, spills,
   static shared bytes), TF32 off;
2. every kernel against its plain PyTorch version at its path's shapes,
   timed beside its bound and a library call that computes the same
   function: the paged-decode kernel (serving; its split and merge
   kernels' device ms per call from torch.profiler, beside CUDA-event ms;
   bf16 at KVH 16 and 4, f32), then the flash forward
   and the two flash backward kernels (training: B=8, S=2048, H=16,
   D=64, bf16, causal; plus f32, offset, fully masked and ragged cases;
   the timed line is followed by a ``forward`` line with the forward's
   TFLOP/s, share of its bound and factor against sdpa's forward, and a
   ``backward`` line with the same for each backward kernel and the
   pair),
   then the conv+BN forward and backward kernels at every distinct 1x1
   conv of ResNet-50 at 128 images (each timed beside the cuBLAS GEMMs
   alone and summed over a ResNet-50 step; plus f32 ragged and wide
   cases and bf16 ragged ones), then the stream copy bit
   for bit at bench.py's probe shape (bf16 [131072, 1024]), ragged and
   misaligned; then the stream copy's own path, the bandwidth probe
   (``bandwidth:`` line: ms and GB/s of torch's elementwise pass, copy_
   and the kernel at 1, 4, 16 and 64 rows per CTA);
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
   profile of one step. Then the same through
   ``make_transformer_train_step_fused`` (buckets launched from the
   gradient hooks, EpilogueSGD in each bucket's epilogue): at tier none
   its losses against the unfused step's, then at fp8_e4m3 with error
   feedback (``train fused:`` line: losses, step ms, buckets, wire and
   logical bytes). Then ResNet-50 with ``fused_conv_bn=True`` as
   ``bench.py`` trains it (224^2, bf16, 128 images, SGD with momentum
   through the bucketed, hook-launched ``DistributedOptimizer`` and
   ``data_parallel_train_step``): at least 36 launches of each conv+BN
   kernel per step, every bucket launched from the hooks, then a profile;
5. card against CPU: a 2-layer f32 serving engine (greedy tokens
   identical, logits within 1e-4), a 2-layer f32 training copy (loss,
   every gradient leaf and the parameters after two SGD steps), a small
   f32 fused ResNet (logits, running statistics, every gradient leaf, the
   parameters after two SGD steps) and the tiny f32 fused step at
   fp8_e4m3 with error feedback (losses, parameters, residual);
6. collectives (world 1): every collective of ``ops.collectives`` and
   ``ops.sparse`` (allgather, alltoall with and without splits,
   reducescatter, ppermute, broadcast, an axis allreduce, the sparse
   allreduce) through NCCL on CUDA tensors, then ``init(mesh_shape=(1,
   1))`` and the hierarchical and two-level allreduce (also with the fp8
   codec), each equal to its plain result.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a GPU, or without the
package, it exits non-zero and prints no result.

``--data-parallel N`` runs only the collectives and training across N
cards of one host: one process per card joins an NCCL world through the
launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``). First the collectives (``collective
<name>:`` lines): allgather (even and uneven), alltoall (even and with
splits), reducescatter (even and uneven), ppermute (a ring), broadcast on
a process set and the sparse allreduce, each at a small odd size and at
64 MiB (nccl-tests' sizes), every rank's result equal to plain torch on
every rank's input (integer values, so sums are exact), with ms and bus
bandwidth, and beside the even ones the ms of the one torch.distributed
call they map to; then ``hierarchical_allreduce`` on (cross 2, local N/2) and
``two_level_allreduce`` on (dcn 2, local N/2) equal to the flat allreduce
at 25 MiB and 256 MiB, with ms beside the flat one's. Then training, each
rank on its rows of the global batch (8 sequences of the flagship, 128
ResNet-50 images, per card). The variants: the unfused flagship, ResNet-50
with the default buckets and with one bucket after the backward
(HOROVOD_GRADIENT_BUCKET_BYTES=0), the fused flagship at tier none and
fp8_e4m3, and the fused flagship through the two-level tier
(HOROVOD_DCN_VIRTUAL_SLICES=2, HOROVOD_DCN_SCHEDULE=two_level) at tier
none and fp8_e4m3 with error feedback; the first two also on one card,
first, as the yardstick. Each ``data parallel <variant>:`` line gives step
ms, throughput, the scaling efficiency where there is a yardstick, from
one profiled step the NCCL kernels' device ms and the part of it that
overlapped compute kernels, and the schedule with its wire and DCN-stage
bytes; every rank must end with the same parameters, a two-level variant's
DCN stage must carry what the schedule predicts, and at tier none its
losses must stay within FUSED_LOSS_REL_TOL of the flat variant's.
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
# conv+BN kernels against their plain versions, relative to the largest
# reference value: bf16 outputs are rounded once to bf16 (2^-8) after f32
# sums in another order; f32 outputs differ in the order of f32 sums.
CONV_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# ResNet-50 training: images per card (in bench.py's sweep), and the
# forward GFLOP per 224^2 image of bench.py's MFU convention (x3 for
# forward and backward).
RESNET_B = 128
RESNET_FWD_FLOPS = 4.1e9
RESNET50_CONVS = 36          # 16 blocks x (conv1, conv3) + 4 projections
RESNET50_BLOCKS = (3, 4, 6, 3)
# Small f32 fused ResNet, card against CPU, relative to each leaf's largest
# value: cuDNN and the CPU sum convolutions in other orders, and batch norm
# over 32 positions in the second stage amplifies that in the gradients.
RESNET_REL_TOL = {"logits": 1e-4, "running_stats": 1e-4, "gradients": 1e-3,
                  "params_after_2_steps": 1e-4}
# The fused flagship at tier none against the unfused step. Losses,
# relative: the first loss is the same forward; later ones follow
# parameters that differ in their last f32 bits (EpilogueSGD's p - lr * m
# against torch.optim.SGD's p + (-lr) * m), which the bf16 forward can
# round to other bf16 values. Sound runs differed by 7.8e-6 at most; the
# unfused losses themselves drift by 1.6e-3 over the 1 + 4 steps, which is
# what a fused step that never updated would show.
FUSED_LOSS_REL_TOL = 1e-4
# Parameters after the 1 + 4 steps, per leaf: max |fused - unfused| over
# max |unfused - initial|. A sound run on an H100 read 1.07e-2 (the same
# last-bit differences, through five bf16 forwards and backwards); a leaf
# whose bucket was never applied reads 1.
FUSED_UPDATE_REL_TOL = 5e-2
# The tiny f32 fused step at fp8_e4m3 with error feedback, card against
# CPU: the two devices' f32 gradients differ in their last bits, so a value
# on an fp8 rounding boundary can round the other way. At most this share
# of a leaf's parameters may differ by more than 1e-5 of its largest value,
# all within 1e-3 (one wire step times the learning rate); losses 1e-5.
FP8_FLIP_SHARE = 5e-3
TINY_CFG = dict(vocab_size=256, d_model=64, n_heads=2, head_dim=32,
                n_layers=2, d_ff=128, max_seq=32)


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
    # Device ms per call from the profiler (the split and the merge kernel
    # summed), beside the CUDA-event ms over 200 back-to-back calls, which
    # at ~10-60 us a call also carries the host's launch cost.
    calls = iter(range(1 << 30))
    res["ms"] = call_device_ms(lambda: fa.flash_paged_decode(
        q, *pools[next(calls) % copies], bt, ln, scale), 20)
    res["event_ms"] = cuda_ms(lambda i: fa.flash_paged_decode(
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
    res["library_ms"] = call_device_ms(lambda: sdpa(
        q4, *gathered[next(calls) % copies], attn_mask=mask, scale=scale),
        20)
    res["library_event_ms"] = cuda_ms(lambda i: sdpa(
        q4, *gathered[i % copies], attn_mask=mask, scale=scale), 200)
    res["bound_by"] = "bytes"
    log(f"{tag}: kernel {res['ms']:.4f} ms device ({res['event_ms']:.4f} "
        f"by events), bound {res['bound_ms']:.4f} ms ("
        f"{res['bound_ms'] / res['ms']:.1%} of it), plain "
        f"{res['plain_ms']:.4f} ms, sdpa {res['library_ms']:.4f} ms device "
        f"({res['library_event_ms']:.4f} by events), "
        f"{res['ms'] / res['library_ms']:.2f}x sdpa")
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
    or the f32 rate. Returns {kernel: (ms, bound_by, operations)}."""
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
                     "bytes" if t_mem >= t_ops else "operations", flops)
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


def profiled_rows(fn, iters: int, names=(), tries: int = 3):
    """``device_rows`` of ``iters`` calls of ``fn`` under torch.profiler,
    after one warm-up call. The profiler now and then hands back no device
    events at all; such a run (or one that misses a kernel of ``names``)
    is profiled again, up to ``tries`` times in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows and all(any(n in key for _, key, _ in rows) for n in names):
            return rows
    raise AssertionError(f"profiler saw no device time for "
                         f"{list(names) or 'any kernel'}")


def kernel_device_ms(fn, names, iters: int = 5):
    """Device ms per launch of each kernel in ``names`` (a substring of
    its symbol, and of no other kernel's that ``fn`` launches) over
    ``iters`` calls of ``fn``, from torch.profiler."""
    return {name: us / 1e3 / count
            for us, key, count in profiled_rows(fn, iters, names)
            for name in names if name in key}


def call_device_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: every kernel it launches, summed over
    ``iters`` calls by torch.profiler, over ``iters``."""
    return sum(r[0] for r in profiled_rows(fn, iters)) / 1e3 / iters


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
    ms, (bound_ms, _, flops) = res["ms"]["flash_fwd"], res["bounds"][
        "flash_fwd"]
    log(f"{tag}: forward " + json.dumps({"flash_fwd": {
        "ms": ms, "tflops": flops / ms / 1e9, "share_of_bound": bound_ms / ms,
        "x_sdpa_fwd": ms / res["library_fwd_ms"]}}))
    bwd = {}
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        ms, (bound_ms, _, flops) = res["ms"][name], res["bounds"][name]
        bwd[name] = {"ms": ms, "tflops": flops / ms / 1e9,
                     "share_of_bound": bound_ms / ms,
                     "x_sdpa_bwd": ms / res["library_bwd_ms"]}
    pair = sum(b_["ms"] for b_ in bwd.values())
    bwd["pair"] = {
        "ms": pair,
        "share_of_bound": sum(res["bounds"][n][0] for n in bwd) / pair,
        "x_sdpa_bwd": pair / res["library_bwd_ms"]}
    log(f"{tag}: backward " + json.dumps(bwd))
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
# phase 2: the conv+BN kernels against their plain versions
# ---------------------------------------------------------------------------

def resnet50_convs(batch: int = RESNET_B, image: int = 224):
    """The distinct 1x1 convs of ResNet-50 at ``batch`` images: (stage,
    what, M, K, N, prologue, stride). M counts the rows the kernel sees
    (after a strided projection subsamples them)."""
    out = []
    side = image // 4                       # after the stem and max-pool
    cin = 64
    for i, f in enumerate((64, 128, 256, 512)):
        stride = 2 if i else 1
        m_in, m_out = batch * side * side, batch * (side // stride) ** 2
        out.append((i + 1, "conv1 block 0", m_in, cin, f, False, 1))
        if i or cin != 4 * f:
            out.append((i + 1, "projection", m_out, cin, 4 * f, False,
                        stride))
        out.append((i + 1, "conv1", m_out, 4 * f, f, False, 1))
        out.append((i + 1, "conv3", m_out, f, 4 * f, True, 1))
        cin, side = 4 * f, side // stride
    return out


def resnet50_conv_count(stage: int, what: str) -> int:
    """Launches a training step makes of a distinct 1x1 conv of
    ``resnet50_convs``: a stage of B bottleneck blocks runs conv1 B - 1
    times past block 0 and conv3 B times."""
    blocks = RESNET50_BLOCKS[stage - 1]
    return {"conv1 block 0": 1, "projection": 1, "conv1": blocks - 1,
            "conv3": blocks}[what]


def conv_bounds(m, k, n, dtype):
    """Least time of each kernel: inputs read once, outputs written once,
    over the card's memory rate; its products (forward 2MKN, backward
    4MKN) at the tensor-core bf16 rate or the f32 rate. Returns {kernel:
    (ms, bound_by)}."""
    es = torch.tensor([], dtype=dtype).element_size()
    rate = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    vec = 4 * (2 * k + 2 * n)               # inv, shift, s1/ds1, s2/ds2
    cases = {"conv_bn_fwd": ((m * k + k * n + m * n) * es + vec,
                             2 * m * k * n),
             "conv_bn_bwd": ((2 * m * k + 2 * m * n + 2 * k * n) * es
                             + vec, 4 * m * k * n)}
    out = {}
    for name, (nbytes, flops) in cases.items():
        t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
        out[name] = (max(t_mem, t_ops) * 1e3,
                     "bytes" if t_mem >= t_ops else "operations")
    return out


def fwd_route(cb, m, k, n, dtype, prologue) -> str:
    """The forward's route for a shape (a tree without routes: "mma")."""
    plan = getattr(cb, "fwd_plan", None)
    return plan(m, k, n, dtype, prologue).route if plan else "mma"


def bwd_route(cb, m, k, n, dtype, prologue) -> str:
    """The backward's route for a shape (a tree without routes: "mma")."""
    plan = getattr(cb, "bwd_plan", None)
    return plan(m, k, n, dtype, prologue).route if plan else "mma"


def check_conv(cb, gen, m, k, n, prologue, dtype, tag, timed=False):
    """Both conv+BN kernels against their plain versions on the same
    inputs; each output's error against CONV_REL_TOL times its largest
    reference value (at least 1). bf16: y, dx and dw are stored in bf16
    (one rounding, 2^-8) after f32 sums in another order; f32: sums in
    another order only. The backward is linear in its three cotangents, so
    it is held to its plain version on each alone (ds1 and ds2 scaled so
    that their terms of dy_eff are as large as dy's) and then on the three
    together at training's scales. Returns {"max_abs_err": {output: (largest
    absolute error, largest share of its limit)}, "route": the backward's
    route, "fwd_route": the forward's}; when ``timed`` also both kernels'
    times by CUDA events, their plain versions', the cuBLAS GEMMs' and the
    bounds, and the forward's device ms a call by torch.profiler (its
    kernels alone: at the small shapes back-to-back calls by events read
    the host's time a call), after checking that two runs give the same
    bits (no float atomics)."""
    dev = torch.device("cuda")
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(dtype)
    inv = shift = None
    if prologue:
        inv = torch.rand((k,), generator=gen, device=dev) + 0.5
        shift = torch.randn((k,), generator=gen, device=dev) * 0.1
    dy = torch.randn((m, n), generator=gen, device=dev).to(dtype)
    ds1 = torch.randn((n,), generator=gen, device=dev) * 1e-2
    ds2 = torch.randn((n,), generator=gen, device=dev) * 1e-3
    fwd = cb.conv_bn_fwd(x, w, inv, shift)
    torch.cuda.synchronize()
    y = fwd[0]
    zdy, zn = torch.zeros_like(dy), torch.zeros_like(ds1)
    cotangents = (("dy", (dy, zn, zn)),
                  ("ds1", (zdy, ds1 * 100.0, zn)),
                  ("ds2", (zdy, zn, ds2 * 500.0)),
                  ("all", (dy, ds1, ds2)))
    errs = {}

    def compare(what, got, want, names):
        for a, ref, nm in zip(got, want, names.split()):
            if ref is None:
                continue
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{tag}: {what} {nm} non-finite")
            e = float((a.float() - ref.float()).abs().max())
            lim = CONV_REL_TOL[dtype] * max(1.0,
                                            float(ref.float().abs().max()))
            if e > lim:
                raise AssertionError(f"{tag}: {what} {nm} disagrees with "
                                     f"its plain version: {e} > {lim}")
            old = errs.get(nm, (0.0, 0.0))
            errs[nm] = (max(old[0], e), max(old[1], e / lim))

    compare("conv_bn_fwd", fwd, cb.conv1x1_bn_stats_plain(x, w, inv, shift),
            "y s1 s2")
    for cot, args in cotangents:
        bwd = cb.conv_bn_bwd(x, w, inv, shift, y, *args)
        torch.cuda.synchronize()
        compare(f"conv_bn_bwd ({cot})", bwd,
                cb.conv1x1_bn_bwd_plain(x, w, inv, shift, y, *args),
                "dx dw dinv dshift")
    route = bwd_route(cb, m, k, n, dtype, prologue)
    froute = fwd_route(cb, m, k, n, dtype, prologue)
    res = {"max_abs_err": errs, "route": route, "fwd_route": froute}
    log(f"conv_bn {tag} M={m} {k}->{n} {str(dtype)[6:]}"
        f"{' prologue' if prologue else ''} (forward: {froute}, backward: "
        f"{route}): max_abs_err (share of limit) "
        + json.dumps({nm: f"{e:.3e} ({share:.3f})"
                      for nm, (e, share) in errs.items()}))
    if not timed:
        return res
    # determinism: a second run gives the same bits (no float atomics);
    # bwd is the last of the loop, all three cotangents
    fwd2 = cb.conv_bn_fwd(x, w, inv, shift)
    bwd2 = cb.conv_bn_bwd(x, w, inv, shift, y, dy, ds1, ds2)
    for a, b in zip(fwd + bwd, fwd2 + bwd2):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{tag}: two runs differ")
    names = ("conv_bn_fwd", "conv_bn_bwd")
    kernel = {"conv_bn_fwd": lambda i: cb.conv_bn_fwd(x, w, inv, shift),
              "conv_bn_bwd": lambda i: cb.conv_bn_bwd(
                  x, w, inv, shift, y, dy, ds1, ds2)}
    plain = {"conv_bn_fwd": lambda i: cb.conv1x1_bn_stats_plain(
                 x, w, inv, shift),
             "conv_bn_bwd": lambda i: cb.conv1x1_bn_bwd_plain(
                 x, w, inv, shift, y, dy, ds1, ds2)}
    # yardstick only (the port never calls it): cuBLAS on the same
    # operands, the GEMM alone — no PyTorch call computes GEMM + BN sums
    gemm = {"conv_bn_fwd": lambda i: x @ w,
            "conv_bn_bwd": lambda i: (dy @ w.t(), x.t() @ dy)}
    res["ms"] = {nm: cuda_ms(kernel[nm], 20) for nm in names}
    res["plain_ms"] = {nm: cuda_ms(plain[nm], 5) for nm in names}
    res["gemm_ms"] = {nm: cuda_ms(gemm[nm], 20) for nm in names}
    res["bounds"] = conv_bounds(m, k, n, dtype)
    res["fwd_device_ms"] = call_device_ms(lambda: kernel["conv_bn_fwd"](0),
                                          5)
    log(f"conv_bn {tag}: kernels " + json.dumps(
        {k_: round(v_, 4) for k_, v_ in res["ms"].items()})
        + f" ms (forward {res['fwd_device_ms']:.4f} ms of device time)"
        + "; plain " + json.dumps(
            {k_: round(v_, 4) for k_, v_ in res["plain_ms"].items()})
        + " ms; cuBLAS GEMM alone " + json.dumps(
            {k_: round(v_, 4) for k_, v_ in res["gemm_ms"].items()})
        + " ms; bounds " + json.dumps(res["bounds"]))
    return res


def conv_step(shapes, name):
    """Log the ``<name> over a ResNet-50 step`` line: each shape's time and
    bound times its launches a step (36 in all), launches per route, and
    per shape ms. Returns {"ms", "bound_ms", "launches"} (and the forward's
    "device_ms")."""
    rows = shapes[name]
    launches = sum(sh["launches_per_step"] for sh in rows)
    if launches != RESNET50_CONVS:
        raise AssertionError(f"{launches} conv launches a step, expected "
                             f"{RESNET50_CONVS}")
    step = {k_: sum(sh[k_] * sh["launches_per_step"] for sh in rows)
            for k_ in ("ms", "bound_ms", "device_ms") if k_ in rows[0]}
    step["launches"] = launches
    log(f"{name} over a ResNet-50 step: " + json.dumps({
        "launches": launches,
        **{k_: round(step[k_], 4) for k_ in ("ms", "device_ms", "bound_ms")
           if k_ in step},
        "share_of_bound": round(step["bound_ms"] / step["ms"], 4),
        "routes": {r: sum(sh["launches_per_step"] for sh in rows
                          if sh["route"] == r)
                   for r in sorted({sh["route"] for sh in rows})},
        "per_shape_ms": {sh["shape"]: round(sh["ms"], 4) for sh in rows}}))
    return step


def check_conv_all(cb, gen):
    """Every distinct 1x1 conv of ResNet-50 at 128 images (bf16), each
    held to its plain version and bitwise repeatable, both kernels timed at
    all 16; a ``conv_bn_fwd over a ResNet-50 step`` and a ``conv_bn_bwd
    over a ResNet-50 step`` line (``conv_step``). Then an f32 ragged case
    (3x7x7 rows, 130 -> 70, prologue), 32 -> 576 in f32 and bf16, bf16 461
    rows of 72 -> 40 with the prologue (the fused route off the 64-wide
    boxes) and bf16 6,273 rows of 72 -> 576 with the prologue (the wgmma
    forward off its row tiles, its K chunks and its column tiles). Returns
    the timed cases (the stage-1 expand conv under "main"; every shape's
    times under "fwd_shapes" and "bwd_shapes"), the step sums ("fwd_step",
    "bwd_step"), and for each output its largest absolute error and
    largest share of its limit over all cases."""
    timed, errs = {}, []
    shapes = {"conv_bn_fwd": [], "conv_bn_bwd": []}
    for stage, what, m, k, n, prologue, stride in resnet50_convs():
        tag = (f"stage {stage} {what}"
               + (f" (stride {stride})" if stride > 1 else ""))
        res = check_conv(cb, gen, m, k, n, prologue, torch.bfloat16, tag,
                         timed=True)
        errs.append(res["max_abs_err"])
        if (stage, what) == (1, "conv3"):
            timed["main"] = res
        for name, route in (("conv_bn_fwd", res["fwd_route"]),
                            ("conv_bn_bwd", res["route"])):
            bound_ms, bound_by = res["bounds"][name]
            shapes[name].append({
                "shape": tag, "m": m, "k": k, "n": n, "prologue": prologue,
                "route": route,
                "launches_per_step": resnet50_conv_count(stage, what),
                "ms": res["ms"][name], "bound_ms": bound_ms,
                "bound_by": bound_by,
                "cublas_gemms_ms": res["gemm_ms"][name],
                **({"device_ms": res["fwd_device_ms"]}
                   if name == "conv_bn_fwd" else {})})
    for name, key in (("conv_bn_fwd", "fwd"), ("conv_bn_bwd", "bwd")):
        timed[f"{key}_shapes"] = shapes[name]
        timed[f"{key}_step"] = conv_step(shapes, name)
    errs.append(check_conv(cb, gen, 147, 130, 70, True, torch.float32,
                           "ragged")["max_abs_err"])
    errs.append(check_conv(cb, gen, 64, 32, 576, False, torch.float32,
                           "wide")["max_abs_err"])
    errs.append(check_conv(cb, gen, 64, 32, 576, True, torch.bfloat16,
                           "wide")["max_abs_err"])
    errs.append(check_conv(cb, gen, 461, 72, 40, True, torch.bfloat16,
                           "ragged M, narrow")["max_abs_err"])
    errs.append(check_conv(cb, gen, 6273, 72, 576, True, torch.bfloat16,
                           "ragged M, K and N")["max_abs_err"])
    worst = {nm: (max(c[nm][0] for c in errs if nm in c),
                  max(c[nm][1] for c in errs if nm in c))
             for nm in dict.fromkeys(nm for c in errs for nm in c)}
    log("conv_bn over all cases, max_abs_err (share of limit): "
        + json.dumps({nm: f"{e:.3e} ({share:.3f})"
                      for nm, (e, share) in worst.items()}))
    return timed, worst


# ---------------------------------------------------------------------------
# phase 2: the stream-copy kernel and the bandwidth probe
# ---------------------------------------------------------------------------

PROBE_ROWS, PROBE_COLS = 131072, 1024    # bench.py's bf16 probe array


def check_stream_copy(sc, gen):
    """The stream-copy kernel against its plain version (out.copy_(x)) bit
    for bit: at the probe's shape at every tile of the probe's sweep, at
    ragged shapes and tiles, at chunks of 80,000 and 5,000 bytes, and on
    views 1..15 bytes off a 16-byte boundary; then its time at the probe's
    shape beside its bound, the plain version's and ``copy_``'s (CUDA
    events; kernel and ``copy_`` twice, interleaved)."""
    dev = torch.device("cuda")
    cases = [((PROBE_ROWS, PROBE_COLS), torch.bfloat16, t)
             for t in (None, 1, 4, 16, 64)]
    cases += [((1000, 37), torch.uint8, 3), ((777, 129), torch.float32, 64),
              ((3, 5, 7), torch.bfloat16, 1), ((300, 40000), torch.uint8, 2),
              ((4097, 1000), torch.uint8, 5)]
    err = 0.0
    for shape, dtype, tile in cases:
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen)
        if dtype != torch.uint8:
            x = torch.randn(shape, device=dev, generator=gen).to(dtype)
        got = sc.stream_copy(x, rows_per_cta=tile)
        want = sc.stream_copy_plain(x, torch.empty_like(x))
        torch.cuda.synchronize()
        err = max(err, float((got.float() - want.float()).abs().max()))
        if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"stream_copy {shape} {dtype} rows/CTA "
                                 f"{tile}: differs from its plain version")
    base = torch.randint(0, 256, (1 << 18,), dtype=torch.uint8, device=dev,
                         generator=gen)
    for so, do in ((1, 1), (3, 7), (0, 8), (16, 5)):
        dst = torch.zeros(1 << 18, dtype=torch.uint8, device=dev)
        xs = base[so:so + 100000].view(1000, 100)
        sc.stream_copy(xs, dst[do:do + 100000].view(1000, 100),
                       rows_per_cta=7)
        torch.cuda.synchronize()
        if not (torch.equal(dst[do:do + 100000], base[so:so + 100000])
                and not dst[:do].any() and not dst[do + 100000:].any()):
            raise AssertionError(f"stream_copy misaligned ({so}, {do}) "
                                 f"differs from its plain version")
    log(f"stream_copy: bit-equal to its plain version over "
        f"{len(cases) + 4} cases (probe shape at every tile, ragged, "
        f"misaligned)")
    x = torch.randn((PROBE_ROWS, PROBE_COLS), device=dev, generator=gen
                    ).to(torch.bfloat16)
    y = torch.empty_like(x)
    nbytes = 2 * x.numel() * x.element_size()
    kernel_ms, lib_ms = [], []
    for _ in range(2):
        kernel_ms.append(cuda_ms(lambda i: sc.stream_copy(x, y), 20))
        lib_ms.append(cuda_ms(lambda i: y.copy_(x), 20))
    res = {"max_abs_err": err, "ms": min(kernel_ms),
           "plain_ms": cuda_ms(lambda i: sc.stream_copy_plain(x, y), 20),
           "library_ms": min(lib_ms),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    log(f"stream_copy bf16 [{PROBE_ROWS}, {PROBE_COLS}]: kernel "
        f"{res['ms']:.4f} ms, bound {res['bound_ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, copy_ {res['library_ms']:.4f} ms "
        f"(kernel, copy_ twice: {[round(t, 4) for t in kernel_ms]}, "
        f"{[round(t, 4) for t in lib_ms]})")
    return res


def bandwidth(sc, card):
    """The probe's main path: launch count zeroed just before
    ``bandwidth_probe`` and read just after; one ``bandwidth:`` line."""
    sc.reset_launches()
    rows = sc.bandwidth_probe("cuda", rows=PROBE_ROWS, cols=PROBE_COLS)
    launches = sc.LAUNCHES["stream_copy"]
    if launches == 0:
        raise AssertionError("the bandwidth probe launched no stream copy")
    log("bandwidth: " + json.dumps({
        "array": f"bf16 [{PROBE_ROWS}, {PROBE_COLS}]",
        "bytes_per_pass": 2 * PROBE_ROWS * PROBE_COLS * 2,
        "data_sheet_gb_s": HBM_BYTES_PER_S / 1e9, "rows": rows,
        "stream_copy_launches": launches, "card": card}))
    return launches


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
    from horovod_tpu_torch.utils import tree as tree_util
    final = [t.detach().clone() for t in tree_util.tree_leaves(state.params)]
    profile_train_step(step, state, batches[-1], card)
    htt.shutdown()
    return launches, [warm_loss] + losses, final


def flagship_fused_step(htt, cfg, dev, seed: int):
    """The flagship through ``make_transformer_train_step_fused`` with
    ``distributed_apply(EpilogueSGD(0.01, momentum=0.9),
    sync_axes=grad_sync_axes(cfg))``, from weights of ``seed``."""
    from horovod_tpu_torch.models import transformer as tfm
    params = htt.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    da = htt.distributed_apply(htt.EpilogueSGD(0.01, momentum=0.9),
                               sync_axes=tfm.grad_sync_axes(cfg))
    init_fn, step = htt.make_transformer_train_step_fused(cfg, da,
                                                          device=dev)
    return init_fn(params), step


def update_rel_diff(got, want, initial) -> float:
    """The largest over the leaves of max |got - want| / max |want -
    initial|: 0 where two trajectories agree, 1 for a leaf that one of
    them left at its initial value."""
    worst = 0.0
    for g, w, i in zip(got, want, initial):
        update = float((w - i).abs().max())
        worst = max(worst, float((g - w).abs().max()) / max(update, 1e-30))
    return worst


def train_flagship_fused(htt, fa, card, unfused_losses, unfused_params,
                         n_steps: int = 4):
    """The fused flagship step (hook-launched buckets, the update in each
    bucket's epilogue), 1 + ``n_steps`` steps through an NCCL world of one
    from the unfused run's seeds: at tier none its losses and final
    parameters against the unfused step's (FUSED_LOSS_REL_TOL,
    FUSED_UPDATE_REL_TOL), then at fp8_e4m3 with error feedback (losses
    finite; wire and logical bytes, bucket count)."""
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.parallel import distributed as D
    from horovod_tpu_torch.utils import tree as tree_util
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    out = {}
    for tier in ("none", "fp8_e4m3"):
        knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", tier)
        htt.init()
        try:
            state, step = flagship_fused_step(htt, cfg, "cuda", seed=0)
            gen = torch.Generator(device="cuda").manual_seed(1)
            batches = [tuple(torch.randint(
                0, cfg.vocab_size, (TRAIN_B, TRAIN_S), generator=gen,
                device="cuda") for _ in range(2)) for _ in range(n_steps + 1)]
            state, loss = step(state, *batches[0])              # warm-up
            losses, stamps = [float(loss)], []
            fa.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for batch in batches[1:]:
                state, loss = step(state, *batch)
                losses.append(float(loss))                  # synchronizes
                stamps.append(time.perf_counter())
            launches = dict(fa.LAUNCHES)
            trace = D.last_wire_trace()
            final = [t.detach() for t in tree_util.tree_leaves(state.params)]
        finally:
            htt.shutdown()
            knobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")
        if not all(np.isfinite(x) for x in losses):
            raise AssertionError(f"fused {tier}: non-finite loss {losses}")
        if min(launches.get(k, 0) for k in ("flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv")) \
                < cfg.n_layers * n_steps:
            raise AssertionError(f"fused {tier}: flash launches {launches}")
        step_ms = [float(x) * 1e3 for x in np.diff([t0] + stamps)]
        res = {"tier": tier, "losses": losses, "step_ms": step_ms,
               "step_ms_mean": float(np.mean(step_ms)),
               "buckets": trace["n_buckets"],
               "wire_bytes": trace["wire_bytes"],
               "logical_bytes": trace["logical_bytes"],
               "error_feedback": trace["error_feedback"],
               "flash_launches": launches}
        if tier == "none":
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(losses, unfused_losses))
            initial = tree_util.tree_leaves(htt.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(0),
                device="cuda"))
            upd = update_rel_diff(final, unfused_params, initial)
            del initial
            res["max_rel_loss_diff_vs_unfused"] = rel
            res["max_param_diff_over_update_vs_unfused"] = upd
            if rel > FUSED_LOSS_REL_TOL or upd > FUSED_UPDATE_REL_TOL:
                raise AssertionError(
                    f"fused step at tier none: losses {losses} differ from "
                    f"the unfused step's {unfused_losses} by {rel}, "
                    f"parameters by {upd} of the update")
        elif not trace["error_feedback"] or trace["tier"] != tier:
            raise AssertionError(f"fused fp8: wire trace {trace}")
        del final
        out[tier] = res
    log("train fused: " + json.dumps({
        "model": "flagship TransformerLM", "batch": TRAIN_B, "seq": TRAIN_S,
        "optimizer": "EpilogueSGD(0.01, momentum=0.9)", "tiers": out,
        "card": card}))


def profile_train_step(step, state, batch, card,
                       label="train profile") -> None:
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
           "kernel_launches": sum(r[2] for r in rows),
           "top_device_ops": [{"op": k_[:70], "ms": us / 1e3, "calls": c}
                              for us, k_, c in rows[:8]],
           "card": card}
    log(f"{label}: " + json.dumps(out))


# ---------------------------------------------------------------------------
# phase 4b: ResNet-50 training at full width and depth
# ---------------------------------------------------------------------------

def resnet_loss(model, images, labels):
    return torch.nn.functional.cross_entropy(model(images, train=True),
                                             labels)


def resnet_step(htt, dev, seed: int):
    """``ResNet50(fused_conv_bn=True)`` (bf16 compute, f32 parameters and
    BN statistics, random weights from ``seed``), SGD(0.01, momentum 0.9)
    through ``DistributedOptimizer``, and ``data_parallel_train_step``."""
    model = htt.ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         fused_conv_bn=True, device=dev, seed=seed)
    opt = htt.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=0.01, momentum=0.9), op=htt.Average)
    init_fn, step, put_batch = htt.data_parallel_train_step(
        resnet_loss, opt, device=dev)
    return init_fn(model), step, put_batch


def resnet_batches(put_batch, n, batch, dev, seed=1):
    """``n`` global batches of ``batch`` synthetic 224^2 bf16 images and
    labels (bench.py's synthetic data), made on the card from ``seed``;
    ``put_batch`` keeps this rank's rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [put_batch((
        torch.rand((batch, 224, 224, 3), generator=gen, device=dev
                   ).to(torch.bfloat16),
        torch.randint(0, 1000, (batch,), generator=gen, device=dev)))
        for _ in range(n)]


def train_resnet50(htt, cb, card, n_steps: int = 4):
    """The ResNet main path: ``runtime.init()`` forms an NCCL world of
    one, then one warm-up step and ``train_loop`` over ``n_steps``
    batches of 128 images, launch counts zeroed just before and read just
    after; then a profile of one step."""
    ctx = htt.init()
    if ctx.backend != "nccl" or htt.size() != 1:
        raise AssertionError(f"expected an NCCL world of one, got "
                             f"{ctx.backend} x {htt.size()}")
    state, step, put_batch = resnet_step(htt, "cuda", seed=0)
    batches = resnet_batches(put_batch, n_steps + 1, RESNET_B, "cuda")
    state, loss = step(state, *batches[0])                  # warm-up
    torch.cuda.synchronize()
    warm_loss = float(loss)
    losses, stamps = [], []

    def on_step(i, st, loss_t):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss_t))

    torch.cuda.reset_peak_memory_stats()
    cb.reset_launches()
    t0 = time.perf_counter()
    state, info = htt.train_loop(step, state, batches[1:], on_step=on_step)
    torch.cuda.synchronize()
    launches = dict(cb.LAUNCHES)
    fwd_routes = dict(getattr(cb, "FWD_ROUTES", {}))
    routes = dict(getattr(cb, "BWD_ROUTES", {}))
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    if info["final_step"] != n_steps + 1 or info["status"] != "completed":
        raise AssertionError(f"train_loop info {info}")
    if not all(np.isfinite(x) for x in [warm_loss] + losses):
        raise AssertionError(f"non-finite loss: {[warm_loss] + losses}")
    opt = state.opt_state
    if len(opt.buckets) < 2 or not all(h for _, h in opt.launch_log):
        raise AssertionError(f"expected every one of several buckets "
                             f"launched from the gradient hooks: "
                             f"{opt.launch_log}")
    for name in ("conv_bn_fwd", "conv_bn_bwd"):
        if launches[name] < RESNET50_CONVS * n_steps:
            raise AssertionError(
                f"{name} launched {launches[name]} times over {n_steps} "
                f"steps of {RESNET50_CONVS} 1x1 convs")
    # every launch of both kernels on a wgmma route (a tree without
    # routes, as a parent measured by tools/compare_trees.py, has none to
    # check)
    for name, rts in (("conv_bn_fwd", fwd_routes), ("conv_bn_bwd", routes)):
        if rts and (rts.get("mma", 0)
                    or sum(rts.values()) != launches[name]):
            raise AssertionError(f"{name} routes {rts}: expected all "
                                 f"{launches[name]} launches on the wgmma "
                                 f"routes")
    step_s = np.diff([t0] + stamps)
    mean_s = float(step_s.mean())
    ips = RESNET_B / mean_s
    train = {
        "model": "ResNet-50 fused_conv_bn", "batch": RESNET_B,
        "image": 224, "steps": n_steps, "warm_loss": warm_loss,
        "losses": losses, "step_ms": [float(x) * 1e3 for x in step_s],
        "step_ms_mean": mean_s * 1e3, "images_per_s": ips,
        "mfu": ips * 3 * RESNET_FWD_FLOPS / BF16_FLOPS_PER_S,
        "mfu_convention": "bench.py: 3 x 4.1 GFLOP per image over 989 TF/s",
        "peak_memory_gb": peak_gb,
        "launches": {k_: launches[k_] for k_ in ("conv_bn_fwd",
                                                  "conv_bn_bwd")},
        "conv_bn_fwd_routes": fwd_routes,
        "conv_bn_bwd_routes": routes,
        "sync_buckets": len(opt.buckets),
        "buckets_launched_from_hooks": sum(h for _, h in opt.launch_log),
        "card": card}
    log("resnet train: " + json.dumps(train))
    profile_train_step(step, state, batches[-1], card,
                       label="resnet train profile")
    htt.shutdown()
    launches["conv_bn_fwd_routes"] = fwd_routes
    launches["conv_bn_bwd_routes"] = routes
    return launches


def resnet_card_vs_cpu(htt) -> None:
    """The small f32 fused ResNet of tests/test_fused_conv_bn.py
    (stage_sizes [1, 1], 8 filters, 10 classes, 2 x 32 x 32 images) with
    the same weights and batch on the CPU (plain versions) and on the card
    (the kernels): train-mode logits, running statistics, every gradient
    leaf, then the parameters after two SGD steps (0.01, momentum 0.9)."""
    from horovod_tpu_torch.models import resnet
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (2,)))
    runs = {}
    for dev in ("cpu", "cuda"):
        model = htt.ResNet(stage_sizes=[1, 1],
                           block_cls=resnet.BottleneckBlock, num_classes=10,
                           num_filters=8, dtype=torch.float32,
                           fused_conv_bn=True, device=dev, seed=3)
        xd, yd = x.to(dev), y.to(dev)
        logits = model(xd, train=True)
        torch.nn.functional.cross_entropy(logits, yd).backward()
        stats = [b.detach().cpu().clone() for b in model.buffers()]
        grads = [p.grad.detach().cpu().clone() for p in model.parameters()]
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        opt.step()
        opt.zero_grad()
        torch.nn.functional.cross_entropy(model(xd, train=True), yd
                                          ).backward()
        opt.step()
        runs[dev] = (logits.detach().cpu(), stats, grads,
                     [p.detach().cpu() for p in model.parameters()])

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    (lc, sc, gc, pc), (lg, sg, gg, pg) = runs["cpu"], runs["cuda"]
    out = {"logits": rel(lg, lc),
           "running_stats": max(rel(a, b) for a, b in zip(sg, sc)),
           "gradients": max(rel(a, b) for a, b in zip(gg, gc)),
           "params_after_2_steps": max(rel(a, b) for a, b in zip(pg, pc))}
    log("resnet card vs cpu (small f32 fused ResNet, 2 x 32^2): worst "
        "relative difference " + json.dumps(
            {k_: float(f"{v_:.2e}") for k_, v_ in out.items()})
        + f" (tol {RESNET_REL_TOL})")
    for k_, v_ in out.items():
        if not v_ <= RESNET_REL_TOL[k_]:
            raise AssertionError(f"resnet card vs cpu: {k_} differ: {v_}")


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


def fused_card_vs_cpu(htt) -> None:
    """The tiny f32 fused step (TINY_CFG, EpilogueSGD(0.05, momentum 0.9),
    fp8_e4m3 with error feedback, small buckets) in a world of one, from
    the same numpy weights and batches on the CPU (gloo) and on the card
    (NCCL): losses, parameters and the residual after three steps."""
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.models import transformer as tfm
    from horovod_tpu_torch.utils import tree as tree_util
    cfg = htt.TransformerConfig(**TINY_CFG, dtype=torch.float32,
                                dp_axis="dp")
    np_params = tree_util.tree_map(lambda t: t.numpy(), htt.init_params(
        cfg, torch.Generator().manual_seed(5), device="cpu"))
    rng = np.random.default_rng(8)
    batches = [(rng.integers(0, 256, (4, 32)), rng.integers(0, 256, (4, 32)))
               for _ in range(3)]
    knobs.set_override("HOROVOD_GRADIENT_COMPRESSION", "fp8_e4m3")
    knobs.set_override("HOROVOD_GRADIENT_BUCKET_BYTES", 64 * 1024)
    runs = {}
    try:
        for dev in ("cpu", "cuda"):
            htt.init(device=dev)
            try:
                da = htt.distributed_apply(
                    htt.EpilogueSGD(0.05, momentum=0.9),
                    sync_axes=tfm.grad_sync_axes(cfg))
                init_fn, step = htt.make_transformer_train_step_fused(
                    cfg, da, device=dev)
                state = init_fn(htt.params_from_numpy(np_params, device=dev))
                losses = []
                for toks, labels in batches:
                    state, loss = step(state, toks, labels)
                    losses.append(float(loss))
                runs[dev] = (losses, [t.detach().cpu() for t in
                                      tree_util.tree_leaves(state.params)],
                             [t.cpu() for t in tree_util.tree_leaves(
                                 state.opt_state.residual)])
            finally:
                htt.shutdown()
    finally:
        knobs.clear_override("HOROVOD_GRADIENT_COMPRESSION")
        knobs.clear_override("HOROVOD_GRADIENT_BUCKET_BYTES")
    (lc, pc, rc), (lg, pg, rg) = runs["cpu"], runs["cuda"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    flip_share, param_rel = 0.0, 0.0
    for a, b in zip(pg, pc):
        top = max(1.0, float(b.abs().max()))
        d = (a - b).abs() / top
        flip_share = max(flip_share, float((d > 1e-5).float().mean()))
        param_rel = max(param_rel, float(d.max()))
    res_close = min(float(((a - b).abs() <= 1e-5).float().mean())
                    for a, b in zip(rg, rc))
    log(f"fused card vs cpu (tiny f32, fp8_e4m3 + error feedback, 3 steps):"
        f" loss rel {loss_rel:.2e}, params worst rel {param_rel:.2e}, "
        f"largest share of a leaf beyond 1e-5 {flip_share:.2e} (tol "
        f"{FP8_FLIP_SHARE:.0e}), residual share within 1e-5 {res_close:.4f}")
    if not (loss_rel <= 1e-5 and param_rel <= 1e-3
            and flip_share <= FP8_FLIP_SHARE and res_close >= 0.95):
        raise AssertionError("the fused fp8 step on the card and on the CPU "
                             "differ")


# ---------------------------------------------------------------------------
# the collectives: a world of one in the default run, N cards with
# --data-parallel N
# ---------------------------------------------------------------------------

def collectives_world_one(htt, dev="cuda") -> None:
    """Every collective of ``ops.collectives`` and ``ops.sparse`` through
    NCCL in a world of one, on tensors of ``dev``, each against its plain
    result exactly; then ``init(mesh_shape=(1, 1))`` with the (cross,
    local) axes and the hierarchical and two-level allreduce at one rank
    each (the two-level one also with the fp8 codec)."""
    from horovod_tpu_torch.compression import WireCodec
    from horovod_tpu_torch.ops import collectives as C
    t0 = time.perf_counter()
    htt.init(device=dev, mesh_shape=(1, 1),
             axis_names=("hvd_cross", "hvd_local"))
    try:
        from horovod_tpu_torch.runtime import get_context
        backend = get_context().backend
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(7, 3, device=dev, generator=g)
        xi = torch.randint(-9, 9, (5, 2), device=dev, generator=g,
                           dtype=torch.int32)
        dense, counts = htt.sparse_allreduce(
            x[:2], torch.tensor([1, 1], device=dev), 4, average=False)
        want_dense = torch.zeros(4, 3, device=dev)
        want_dense[1] = x[0] + x[1]
        codec = WireCodec("fp8_e4m3")
        wire, scale = codec.encode(x, world=1)
        checks = {
            "allgather": (C.allgather(x), x),
            "allgather_bf16": (C.allgather(x.bfloat16()), x.bfloat16()),
            "alltoall": (C.alltoall(x), x),
            "alltoall_splits": (C.alltoall(x, splits=[7])[0], x),
            "reducescatter": (C.reducescatter(x, htt.Sum), x),
            "reducescatter_int": (C.reducescatter(xi, htt.Sum), xi),
            "reducescatter_max": (C.reducescatter(x, htt.Max), x),
            "ppermute": (C.ppermute(x, [(0, 0)]), x),
            "broadcast": (C.broadcast(x, 0), x),
            "allreduce_axis_local": (C.allreduce(x, htt.Sum,
                                                 axis="hvd_local"), x),
            "sparse_allreduce": (dense, want_dense),
            "sparse_counts": (counts, torch.tensor(
                [0, 2, 0, 0], dtype=torch.int32, device=dev)),
            "hierarchical_allreduce": (C.hierarchical_allreduce(x[:6]),
                                       x[:6]),
            "two_level_allreduce": (C.two_level_allreduce(
                x, htt.Average, ici_axes=("hvd_local",),
                dcn_axis="hvd_cross"), x),
            "two_level_allreduce_fp8": (C.two_level_allreduce(
                x, htt.Sum, ici_axes=("hvd_local",), dcn_axis="hvd_cross",
                wire_codec=codec), codec.decode(wire, scale, x.dtype))}
        if dev == "cuda":
            torch.cuda.synchronize()
        bad = [name for name, (got, ref) in checks.items()
               if got.device != ref.device or got.dtype != ref.dtype
               or not torch.equal(got, ref)]
    finally:
        htt.shutdown()
    if bad:
        raise AssertionError(f"collectives (world 1): {bad} differ from "
                             f"their plain results")
    log("collectives (world 1): " + json.dumps({
        "backend": backend, "checked_exactly": sorted(checks),
        "seconds": round(time.perf_counter() - t0, 3)}))


def _int_valued(gen, shape, dev, dtype=torch.float32):
    """Integer values in [-1000, 1000), so every sum of a few ranks is
    exact in f32 and a comparison can be exact."""
    return torch.randint(-1000, 1000, shape, generator=gen, device=dev
                         ).to(dtype)


def coll_unit(big: bool, world: int) -> int:
    """Rows a rank's share holds: 64 MiB of 1024-wide f32 rows over the
    world, or 251 rows of 3 (a small, odd size)."""
    return COLL_BIG_BYTES // (4 * 1024 * world) if big else 251


def coll_splits(r, world, unit):
    """Rank r's alltoall send counts: unequal, ``unit`` + 0, 5 or 10."""
    return [unit + (r + d) % 3 * 5 for d in range(world)]


def coll_case_inputs(case, r, world, big, dev):
    """Rank r's input of one ``collective`` case, seeded by case, size and
    rank, so that every rank can rebuild every rank's input."""
    gen = torch.Generator(device=dev).manual_seed(
        1000 * (COLL_CASES.index(case) + 1) + 10 * r + int(big))
    cols, unit = (1024 if big else 3), coll_unit(big, world)
    rows = {"allgather": unit, "allgather_uneven": unit + 37 * r,
            "alltoall": world * unit, "reducescatter": world * unit,
            "alltoall_splits": sum(coll_splits(r, world, unit)),
            "reducescatter_uneven": world * unit + 3,
            "ppermute_ring": world * unit,
            "broadcast_process_set": world * unit}
    if case == "sparse_allreduce":
        nnz = unit + 11 * r
        return (_int_valued(gen, (nnz, cols), dev),
                torch.randint(0, 4 * unit, (nnz,), generator=gen,
                              device=dev))
    return _int_valued(gen, (rows[case], cols), dev)


def coll_run(htt, case, x, r, world, unit, ps):
    """Rank r's call of ``case`` on its input ``x``."""
    from horovod_tpu_torch.ops import collectives as C
    if case in ("allgather", "allgather_uneven"):
        return C.allgather(x)
    if case == "alltoall":
        return C.alltoall(x)
    if case == "alltoall_splits":
        return C.alltoall(x, splits=coll_splits(r, world, unit))[0]
    if case in ("reducescatter", "reducescatter_uneven"):
        return C.reducescatter(x, htt.Sum)
    if case == "ppermute_ring":
        return C.ppermute(x, [(i, (i + 1) % world) for i in range(world)])
    if case == "broadcast_process_set":
        return C.broadcast(x, root_rank=1, process_set=ps)
    if case == "sparse_allreduce":
        return htt.sparse_allreduce(x[0], x[1], 4 * unit)[0]
    raise KeyError(case)


def coll_plain(case, xs, r, world, unit):
    """Rank r's result of ``case`` in plain torch from every rank's
    input."""
    if case in ("allgather", "allgather_uneven"):
        return torch.cat(xs)
    if case == "alltoall":
        return torch.cat([x.chunk(world)[r] for x in xs])
    if case == "alltoall_splits":
        return torch.cat([x.split(coll_splits(s, world, unit))[r]
                          for s, x in enumerate(xs)])
    if case in ("reducescatter", "reducescatter_uneven"):
        total = torch.stack(xs).sum(0)
        base, rem = divmod(total.shape[0], world)
        return total.split([base + (1 if i < rem else 0)
                            for i in range(world)])[r]
    if case == "ppermute_ring":
        return xs[(r - 1) % world]
    if case == "broadcast_process_set":
        return xs[1] if r in (0, 1, 2) else xs[r]
    if case == "sparse_allreduce":
        vals = torch.cat([v for v, _ in xs])
        dense = vals.new_zeros((4 * unit, vals.shape[1]))
        return dense.index_add_(0, torch.cat([i for _, i in xs]),
                                vals) / world
    raise KeyError(case)


def coll_bytes(case, xs, r, world):
    """(nccl-tests size in bytes, bus-bandwidth factor) of ``case``:
    all-gathers count their output, reduce-scatters their input,
    all-to-alls one rank's send buffer, the rest the tensor;
    busbw = size / time x factor."""
    nb = [int(x.numel() * x.element_size()) if torch.is_tensor(x)
          else int(x[0].numel() * x[0].element_size()) for x in xs]
    ring = (world - 1) / world
    if case in ("allgather", "allgather_uneven", "sparse_allreduce"):
        return sum(nb), ring
    if case in ("alltoall", "alltoall_splits", "reducescatter",
                "reducescatter_uneven"):
        return nb[r], ring
    return nb[r], 1.0


COLL_CASES = ["allgather", "allgather_uneven", "alltoall",
              "alltoall_splits", "reducescatter", "reducescatter_uneven",
              "ppermute_ring", "broadcast_process_set", "sparse_allreduce"]
COLL_BIG_BYTES = 64 << 20
COLL_ITERS = {False: 50, True: 10}


def coll_bare(case, x, rank, world):
    """The one ``torch.distributed`` call an even case maps to, on the
    default group and the same input (None for the others): what the
    port's wrapper adds shows beside it."""
    import torch.distributed as dist
    if case == "allgather":
        out = x.new_empty((world * x.shape[0],) + x.shape[1:])
        return lambda: dist.all_gather_into_tensor(out, x)
    if case == "alltoall":
        out = torch.empty_like(x)
        return lambda: dist.all_to_all_single(out, x)
    if case == "reducescatter":
        out = x.new_empty((x.shape[0] // world,) + x.shape[1:])
        return lambda: dist.reduce_scatter_tensor(out, x)
    if case == "ppermute_ring":
        out = torch.empty_like(x)

        def ring():
            for w in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, (rank + 1) % world),
                    dist.P2POp(dist.irecv, out, (rank - 1) % world)]):
                w.wait()
        return ring
    return None


def _coll_timed(fn, iters, dev):
    """ms a call of ``fn`` over ``iters`` calls, after two untimed ones
    (so allocator growth and lazy set-up stay out), by CUDA events."""
    for _ in range(2):
        fn()
    if dev != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def coll_rank(rank, world, port, results, device="cuda"):
    """One rank of the collectives' N-card world. (a) every case at a
    small ragged size and at 64 MiB against plain torch on every rank's
    input (rebuilt from the seeds), exactly (integer values), then timed;
    (b) ``hierarchical_allreduce`` on (cross 2, local N/2) and
    ``two_level_allreduce`` on (dcn 2, local N/2) against the flat
    allreduce at 25 MiB and 256 MiB, exactly, and timed. The process
    group is made here, so each ``init`` builds its topology on it."""
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.ops import collectives as C
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method="env://")
    dev = device
    try:
        htt.init(device=device)
        # rank 0, which reports the times, is a member; its root is rank 1
        ps = htt.add_process_set([0, 1, 2])
        for case in COLL_CASES:
            line = {"world": world}
            for big in (False, True):
                unit = coll_unit(big, world)
                xs = [coll_case_inputs(case, s, world, big, dev)
                      for s in range(world)]
                mine = xs[rank]
                got = coll_run(htt, case, mine, rank, world, unit, ps)
                want = coll_plain(case, xs, rank, world, unit)
                ok = torch.tensor([float(torch.equal(got, want))],
                                  device=dev)
                size, factor = coll_bytes(case, xs, rank, world)
                del got, want, xs
                htt.barrier()
                ms = _coll_timed(lambda: coll_run(htt, case, mine, rank,
                                                  world, unit, ps),
                                 COLL_ITERS[big], dev)
                tag = "64mib" if big else "small"
                bare = coll_bare(case, mine, rank, world)
                if bare is not None:
                    htt.barrier()
                    line[f"torch_dist_ms_{tag}"] = _coll_timed(
                        bare, COLL_ITERS[big], dev)
                line[f"exact_{tag}"] = bool(
                    htt.allreduce(ok, htt.Min).item() == 1.0)
                line[f"bytes_{tag}"] = size
                line[f"ms_{tag}"] = ms
                line[f"busbw_gb_s_{tag}"] = size / (ms * 1e-3) * factor / 1e9
                del mine
            if rank == 0:
                results.put(("collective " + case, line))
        htt.shutdown()
        for name, kw, fn in (
                ("hierarchical_allreduce", {"mesh_shape": (2, world // 2)},
                 lambda x: C.hierarchical_allreduce(x, htt.Sum)),
                ("two_level_allreduce", {"dcn": 2},
                 lambda x: C.two_level_allreduce(
                     x, htt.Sum, ici_axes=("hvd_local",)))):
            htt.init(device=device, **kw)
            from horovod_tpu_torch.runtime import get_context
            line = {"world": world,
                    "mesh": get_context().topology.mesh.shape}
            for mib in (25, 256):
                gen = torch.Generator(device=dev).manual_seed(rank + mib)
                x = _int_valued(gen, ((mib << 20) // 4,), dev)
                got, flat = fn(x), htt.allreduce(x, htt.Sum)
                ok = torch.tensor([float(torch.equal(got, flat))],
                                  device=dev)
                htt.barrier()
                line[f"exact_vs_flat_{mib}mib"] = bool(
                    htt.allreduce(ok, htt.Min).item() == 1.0)
                line[f"ms_{mib}mib"] = _coll_timed(lambda: fn(x), 10, dev)
                line[f"flat_ms_{mib}mib"] = _coll_timed(
                    lambda: htt.allreduce(x, htt.Sum), 10, dev)
                del x, got, flat
            if rank == 0:
                results.put(("collective " + name, line))
            htt.shutdown()
    finally:
        if htt.is_initialized():
            htt.shutdown()
        dist.destroy_process_group()


def collectives_n_cards(n, card, device="cuda") -> None:
    """``coll_rank`` in ``n`` spawned processes; one ``collective
    <name>:`` line per case, each failing the run unless exact."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [ctx.Process(target=coll_rank, args=(r, n, port, results),
                         kwargs={"device": device}) for r in range(n)]
    for p in procs:
        p.start()
    lines = [results.get(timeout=600) for _ in range(len(COLL_CASES) + 2)]
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"a rank of the {n}-card collectives world "
                             f"failed: {[p.exitcode for p in procs]}")
    for name, line in lines:
        line["card"] = card
        log(f"{name}: " + json.dumps(line))
        if not all(v for k, v in line.items() if k.startswith("exact")):
            raise AssertionError(f"{name}: a result differs from plain "
                                 f"torch: {line}")


# ---------------------------------------------------------------------------
# --data-parallel N: the training step across N cards
# ---------------------------------------------------------------------------

def nccl_overlap(prof):
    """From a profiled step's device events: the NCCL kernels' device ms,
    the part of it during which a compute kernel also ran, and the
    compute kernels' ms (copies and memsets count as neither)."""
    def merged(ivs):
        out = []
        for a, b in sorted(ivs):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    nccl, comp = [], []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        name = ev.name.lower()
        if b <= a or name.startswith(("memcpy", "memset")):
            continue
        (nccl if "nccl" in name else comp).append((a, b))
    comp_m, nccl_m = merged(comp), merged(nccl)
    overlap = 0.0
    for a, b in nccl_m:
        for c, d in comp_m:
            overlap += max(0.0, min(b, d) - max(a, c))
    return {"nccl_ms": sum(b - a for a, b in nccl_m) / 1e3,
            "nccl_overlapped_ms": overlap / 1e3,
            "compute_ms": sum(b - a for a, b in comp_m) / 1e3}


def dp_variant(htt, rank, world, dev, variant, n_steps):
    """Build one variant's step and its batches (this rank's rows)."""
    model = variant["model"]
    if model == "resnet":
        state, step, put_batch = resnet_step(htt, dev, seed=rank)
        batches = resnet_batches(put_batch, n_steps + 2, RESNET_B * world,
                                 dev)
        return state, step, batches, RESNET_B * world, "images"
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    if model == "fused":
        state, step = flagship_fused_step(htt, cfg, dev, seed=rank)
    else:
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
                     for _ in range(2)) for _ in range(n_steps + 2)]
    return state, step, batches, b * s * world, "tokens"


def dp_rank(rank, world, port, results, variants, device="cuda",
            n_steps=4):
    """One rank of an N-card world: each variant (``model`` transformer,
    fused or resnet, with ``knobs`` overridden while it runs) trains from
    other weights on every rank (init broadcasts rank 0's) on its rows of
    each global batch: a warm-up step, ``n_steps`` timed steps, then one
    step under torch.profiler on rank 0 (the NCCL kernels' overlap with
    compute). Rank 0 puts each variant's numbers on ``results``."""
    import torch.distributed as dist
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import horovod_tpu_torch as htt
    from horovod_tpu_torch.config import knobs
    from horovod_tpu_torch.parallel import distributed as D
    from horovod_tpu_torch.utils import tree as tree_util
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(rank)
    # the process group outlives each init, so a variant with topology
    # knobs re-inits on it
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method="env://")
    topo = None
    for variant in variants:
        for k, v in variant.get("knobs", {}).items():
            knobs.set_override(k, v)
        want = {k: v for k, v in variant.get("knobs", {}).items()
                if k in TOPOLOGY_KNOBS}
        if want != topo:
            if htt.is_initialized():
                htt.shutdown()
            ctx = htt.init(device=device)
            topo = want
        dev = ctx.device
        state, step, batches, units, unit = dp_variant(
            htt, rank, world, dev, variant, n_steps)
        state, _ = step(state, *batches[0])                # warm-up
        losses, stamps = [], []
        htt.barrier()
        t0 = time.perf_counter()
        for batch in batches[1:-1]:
            state, loss = step(state, *batch)
            losses.append(float(loss))                      # synchronizes
            stamps.append(time.perf_counter())
        htt.barrier()
        torch.cuda.synchronize()
        if rank == 0:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                tp = time.perf_counter()
                state, loss = step(state, *batches[-1])
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - tp) * 1e3
            overlap = nccl_overlap(prof)
        else:
            state, loss = step(state, *batches[-1])
        losses.append(float(loss))
        trace = D.last_wire_trace()
        predicted = (predicted_dcn_bytes(htt, state,
                                         ctx.topology.local_size)
                     if trace["schedule"] == "two_level" else 0)
        for k in variant.get("knobs", {}):
            knobs.clear_override(k)
        leaves = (list(state.params.parameters())
                  if variant["model"] == "resnet"
                  else tree_util.tree_leaves(state.params))
        total = sum(float(t.detach().double().sum()) for t in leaves)
        lo = htt.allreduce(torch.tensor([total], dtype=torch.float64,
                                        device=dev), htt.Min)
        hi = htt.allreduce(torch.tensor([total], dtype=torch.float64,
                                        device=dev), htt.Max)
        if rank == 0:
            step_s = np.diff([t0] + stamps)
            results.put({
                "variant": variant["label"], "world": world,
                "losses": losses,
                "step_ms": [float(x) * 1e3 for x in step_s],
                "step_ms_mean": float(step_s.mean()) * 1e3,
                f"{unit}_per_s": units / float(step_s.mean()),
                "profiled_step_ms": prof_ms, **overlap,
                "sync_buckets": trace["n_buckets"],
                "wire_bytes": trace["wire_bytes"],
                "logical_bytes": trace["logical_bytes"],
                "schedule": trace["schedule"],
                "dcn_wire_bytes": trace["dcn_wire_bytes"],
                "dcn_wire_bytes_predicted": predicted,
                "mesh": ctx.topology.mesh.shape,
                "params_equal_across_ranks": float(lo) == float(hi)})
        del state, step, batches
        if device == "cuda":
            torch.cuda.empty_cache()
    htt.shutdown()
    dist.destroy_process_group()


def run_world(world, variants, **kw):
    """``dp_rank`` in ``world`` spawned processes; rank 0's results, one
    per variant."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [ctx.Process(target=dp_rank,
                         args=(r, world, port, results, variants), kwargs=kw)
             for r in range(world)]
    for p in procs:
        p.start()
    out = [results.get(timeout=900) for _ in variants]   # before the join
    for p in procs:
        p.join(timeout=120)
    for p in procs:
        if p.is_alive():
            p.kill()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"a rank of the {world}-card world failed: "
                             f"{[p.exitcode for p in procs]}")
    return {r["variant"]: r for r in out}


def predicted_dcn_bytes(htt, state, local: int) -> int:
    """What the two-level schedule predicts each rank's DCN stage carries
    over a step: per bucket and dtype, 1/local of its elements (rounded
    up) in the wire dtype, plus a 4-byte scale on the fp8 tiers. The plan
    is the step's own (the same knobs, leaves and sync axes)."""
    from horovod_tpu_torch.models import transformer as tfm
    cfg = flagship_cfg(htt.TransformerConfig, mlp_recompute=True,
                       dp_axis="dp")
    da = htt.distributed_apply(htt.EpilogueSGD(0.01, momentum=0.9),
                               sync_axes=tfm.grad_sync_axes(cfg))
    _, leaves, sync = da._sync(state.params)
    total = 0
    for _, idxs in sync.buckets:
        by_dtype = {}
        for i in idxs:
            by_dtype[leaves[i].dtype] = (by_dtype.get(leaves[i].dtype, 0)
                                         + leaves[i].numel())
        for dtype, n in by_dtype.items():
            chunk = -(-n // local)
            codec = sync.codec
            if codec is not None and codec.compresses(dtype):
                total += chunk * codec.wire_itemsize + (4 if codec.scaled
                                                        else 0)
            else:
                total += chunk * dtype.itemsize
    return total


# Knobs read by init: a variant that sets one re-inits on the world.
TOPOLOGY_KNOBS = ("HOROVOD_DCN_VIRTUAL_SLICES", "HOROVOD_DCN_MESH",
                  "HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_TORUS_ALLREDUCE",
                  "HOROVOD_TPU_MESH_SHAPE", "HOROVOD_TPU_MESH_AXES")
# The two-level tier's variants: the flagship through the bucketed sync
# (make_transformer_train_step_fused, the path that carries the wire tier;
# the unfused step's sync is one plain allreduce per dtype, as the JAX
# package's sync_gradients is) on (hvd_dcn 2, hvd_local N/2), against the
# flat "fused transformer none" of the same world.
DCN_KNOBS = {"HOROVOD_DCN_VIRTUAL_SLICES": 2,
             "HOROVOD_DCN_SCHEDULE": "two_level"}

# The --data-parallel variants: the unfused flagship and bucketed ResNet-50
# (one card as the yardstick, then N), then, on N cards only, ResNet-50 with
# one bucket after the backward, the fused flagship at tier none and
# fp8_e4m3, and the fused flagship through the two-level tier at both.
DP_YARDSTICK = [
    dict(label="transformer", model="transformer"),
    dict(label="resnet bucketed", model="resnet")]
DP_VARIANTS = DP_YARDSTICK + [
    dict(label="resnet one bucket", model="resnet",
         knobs={"HOROVOD_GRADIENT_BUCKET_BYTES": 0}),
    dict(label="fused transformer none", model="fused",
         knobs={"HOROVOD_GRADIENT_COMPRESSION": "none"}),
    dict(label="fused transformer fp8_e4m3", model="fused",
         knobs={"HOROVOD_GRADIENT_COMPRESSION": "fp8_e4m3"}),
    dict(label="fused transformer dcn2 two_level none", model="fused",
         knobs={**DCN_KNOBS, "HOROVOD_GRADIENT_COMPRESSION": "none"}),
    dict(label="fused transformer dcn2 two_level fp8_e4m3", model="fused",
         knobs={**DCN_KNOBS, "HOROVOD_GRADIENT_COMPRESSION": "fp8_e4m3",
                "HOROVOD_GRADIENT_ERROR_FEEDBACK": "1"})]


def data_parallel(n: int, card: str, **kw) -> None:
    """Every variant on ``n`` cards, the yardsticks on one card first; one
    ``data parallel <variant>:`` line each."""
    one = run_world(1, DP_YARDSTICK, **kw)
    many = run_world(n, DP_VARIANTS, **kw)
    for label, res in many.items():
        for r in ([res, one[label]] if label in one else [res]):
            if not (r["params_equal_across_ranks"]
                    and all(np.isfinite(x) for x in r["losses"])):
                raise AssertionError(f"data-parallel run failed: {r}")
        line = {"n_cards": res, "card": card}
        if "two_level" in label:
            check_two_level_variant(label, res, many)
        if label in one:
            unit = "tokens" if "transformer" in label else "images"
            line["one_card"] = one[label]
            res["scaling_efficiency"] = res[f"{unit}_per_s"] / (
                n * one[label][f"{unit}_per_s"])
        log(f"data parallel {label}: " + json.dumps(line))


def check_two_level_variant(label, res, many) -> None:
    """A two-level variant ran the tier, its DCN stage carried what the
    schedule predicts, and at tier none its losses stay within
    FUSED_LOSS_REL_TOL of the flat variant's in the same world."""
    if res["schedule"] != "two_level" or res["dcn_wire_bytes"] != \
            res["dcn_wire_bytes_predicted"] or not res["dcn_wire_bytes"]:
        raise AssertionError(f"{label}: the tier did not run as planned: "
                             f"{res}")
    if label.endswith("none"):
        flat = many["fused transformer none"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], flat))
        res["max_rel_loss_diff_vs_flat"] = rel
        if rel > FUSED_LOSS_REL_TOL:
            raise AssertionError(f"{label}: losses {res['losses']} differ "
                                 f"from the flat schedule's {flat} by {rel}")


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
    from horovod_tpu_torch.ops import conv_bn as cb
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import stream_copy as sc
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
    # ptxas notes C75xx when it serializes or fences wgmma behind the
    # source's back (PERF.md)
    log("ptxas C75xx notes per library: " + json.dumps(
        {name: text.count("(C75") for name, text in _build.build_logs.items()}))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if n_dp:
        collectives_n_cards(n_dp, card)
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
    conv_case, conv_errs = check_conv_all(cb, gen)
    copy_case = check_stream_copy(sc, gen)
    copy_launches = bandwidth(sc, card)

    # phase 3: serving at full width
    launches, live_err = serve_flagship(htt, fa, kvc, card)
    errs.append(live_err)

    # phase 4: training at full width and depth
    train_launches, unfused_losses, unfused_params = train_flagship(
        htt, fa, card)
    train_flagship_fused(htt, fa, card, unfused_losses, unfused_params)
    del unfused_params
    resnet_launches = train_resnet50(htt, cb, card)

    # phase 5: card against CPU
    card_vs_cpu(htt)
    train_card_vs_cpu(htt)
    resnet_card_vs_cpu(htt)
    fused_card_vs_cpu(htt)

    # phase 6: the collectives through NCCL in a world of one
    collectives_world_one(htt)

    kernels = [{
        "name": "paged_decode", "route": "cuda",
        "source": "horovod_tpu_torch/csrc/paged_decode.cu",
        "replaces": "horovod_tpu/ops/pallas/flash_attention.py:498",
        "launches": launches["paged_decode"],
        "max_abs_err": max(errs),
        **{k_: main_case[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "event_ms", "library_event_ms")}}]
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
        bound_ms, bound_by, _ = flash_case["bounds"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{src}",
            "replaces": f"horovod_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": train_launches[name],
            "max_abs_err": flash_errs[name],
            "ms": flash_case["ms"][name], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    # The conv+BN rows carry the stage-1 expand conv (M = 401,408, 64 ->
    # 256, bf16, prologue), the largest of the path; no single PyTorch call
    # computes a GEMM with BN statistics, so library_ms is null (the cuBLAS
    # GEMM alone is printed beside the kernels). Its outputs' scales differ
    # by up to 1e5 (y against sum(y^2)), so beside the largest absolute
    # error over them each output's own error and its largest share of its
    # limit (CONV_REL_TOL of its largest value) are listed.
    main_conv = conv_case["main"]
    for name, line, outs in (("conv_bn_fwd", 78, "y s1 s2"),
                             ("conv_bn_bwd", 137, "dx dw dinv dshift")):
        bound_ms, bound_by = main_conv["bounds"][name]
        by_out = {nm: conv_errs[nm] for nm in outs.split()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"horovod_tpu_torch/csrc/{name}.cu",
            "replaces": f"horovod_tpu/ops/pallas/conv_bn.py:{line}",
            "launches": resnet_launches[name],
            "max_abs_err": max(e for e, _ in by_out.values()),
            "max_abs_err_by_output": {nm: e for nm, (e, _) in by_out.items()},
            "share_of_limit_by_output": {nm: s for nm, (_, s)
                                         in by_out.items()},
            "ms": main_conv["ms"][name],
            "plain_ms": main_conv["plain_ms"][name],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "resnet50_step": conv_case[f"{name[-3:]}_step"],
            "routes": resnet_launches[f"{name}_routes"]})
    # The stream copy: its main path is the bandwidth probe; timed at the
    # probe's shape (bf16 [131072, 1024]). The plain version is
    # out.copy_(x), and copy_ alone is the library yardstick.
    kernels.append({
        "name": "stream_copy", "route": "cuda",
        "source": "horovod_tpu_torch/csrc/stream_copy.cu",
        "replaces": "bench.py:815", "launches": copy_launches,
        **{k_: copy_case[k_] for k_ in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")}})
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
