#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # one card; takes no arguments

Phases, all of them on every run, in this order:
  device   card name and power limit (nvidia-smi); builds every kernel from
           ray_tpu_torch/csrc/ and prints the build time and ptxas report.
  kernels  each kernel against its plain PyTorch version on the card, in
           bf16, at the serving and training paths' shapes (K1', K2 and K3
           also at ViT-L's: head dim 64, one q head per kv head, 196 rows,
           not causal); max abs error
           against a stated tolerance; kernel, plain, library and bound
           times. Paged attention also at a second shape (4 slots of
           1537..2048 rows), with its time inside a CUDA graph (device_ms)
           and the wrapper's host time per call (host_us).
  model    llama_1b at full width (random weights from a seed): one batched
           paged_prefill and a few paged_decode_one ticks, once through the
           kernels and once through the plain versions; logits compared.
  serve    LLMEngine(llama_1b, paged) serving 64 concurrent greedy requests;
           every request returns its tokens, and the kernels' launch counts
           match the engine's prefill programs and decode ticks exactly.
  train    (a) loss and every gradient of llama_1b (22 layers), B2 S2048,
           remat save_attn, through the kernels against the plain path,
           with the peak memory of each; (b) the train step at full llama_1b (22 layers), save_attn,
           B8 S2048 (ray_tpu_torch.bench): 3 warm-up steps, then 10 timed
           steps, each of which must launch the lse forward, dQ and dK/dV
           kernels exactly once per layer and the plain forward kernel never.
  rl       the GRPO path (ray_tpu_torch.rl) at full llama_1b, bf16, save_attn,
           attention_impl "auto": (a) GRPO loss and every gradient at B8 S320
           (prompts of 32..256 tokens; old and reference logprobs through
           make_logprob_fn), kernels against the plain path; (b) GRPOTrainer,
           3 train_steps of 8 prompts x 4 samples x 64 new tokens at
           temperature 1.0 through LLMEngine (32 slots), with exact launch
           counts and the frozen reference policy checked bitwise.
  vit      ViT-L/16 (ray_tpu_torch.models.vit) at 224 px, all 24 layers, 1000
           classes, bf16, batch 32, attention_impl "auto" (head dim 64, one q
           head per kv head, not causal): (a) loss and every gradient, kernels
           against the plain path; (b) one no-grad forward, the forward kernel
           once a layer, logits against the plain forward's; (c) 3 warm-up and
           10 timed steps of make_vit_train_step with adamw(1e-3), each
           launching the lse forward, dQ and dK/dV kernels once a layer.
  mesh     the port's mesh (ray_tpu_torch.parallel) at world size 1, on NCCL:
           (a) make_mesh(MeshConfig()) on cuda, and the first collective on
           it and on a seven-dim mesh of size-1 dims; (b) llama_1b (22
           layers, bf16, save_attn, attention "auto") loss and every
           gradient through llama_loss(..., mesh=mesh) against the unsharded
           port, B2 S2048; (c) make_train_step(mesh=mesh) at B8 S2048, 3
           warm-up and 5 timed steps, each launching the lse forward, dQ and
           dK/dV kernels exactly once a layer, in turns with the unsharded
           step on the same tensors (ms a step; then one step of each under
           torch.profiler: the device's busy time and the host's top ops);
           (d) ulysses_attention_sharded with the port's attention at
           llama_1b's heads, B8 S2048: one flash_fwd launch, against the
           plain attention; (e) moe_apply at llama_1b's widths (hidden 2048,
           ffn 8192, 8 experts, top-2, 16384 tokens) in bf16 against the
           same call in fp32 on the bf16-rounded inputs.

Every launch check also requires attention_plain == paged_attention_plain
== 0: the dispatch rule sends no llama_1b or ViT-L call to a plain version,
and under the mesh the attention reaches the kernels through local_map.

Prints {"kernels": [...]} and the nvidia-smi line before the last line; the
last line is {"ok": true, "device": {...}} only when every phase passed. Any
failure exits non-zero and prints no result. Each kernel's launches come
from the phase whose path runs it (serve: flash_fwd, paged_attention; train:
flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv; the latter three also carry
launches_vit, from the vit phase's timed steps). A copy of the results goes to
build/chip_smoke.json.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

PHASES = ("device", "kernels", "model", "serve", "train", "rl", "vit", "mesh")

# Tolerance, bf16 kernel output against the plain version (fp32 math on the
# same bf16 inputs, output rounded to bf16): |kernel - plain| <= ATOL + RTOL *
# |plain| elementwise. RTOL is PyTorch's bf16 default (two ulps of bf16's
# 8-bit mantissa: both sides round to bf16 once); ATOL covers outputs near 0,
# where the kernel's bf16 probabilities in P.V leave absolute error.
KERNEL_RTOL, KERNEL_ATOL = 1.6e-2, 1e-2
# Attention gradients, backward kernels against the plain backward (fp32 math
# on the same bf16 inputs): |kernel - plain| <= GRAD_ATOL * max|plain| +
# KERNEL_RTOL * |plain|. Both round to bf16 once (the rtol); the kernels'
# bf16 p and ds in the products leave absolute error of a few bf16 ulps of
# the gradient's own scale (the atol, relative to the largest gradient).
GRAD_ATOL = 1e-2
# lse, forward kernel against the plain log-sum-exp: both fp32, from the same
# bf16 inputs; only the order of the sums differs.
LSE_ATOL, LSE_RTOL = 1e-3, 1e-4
# Model logits, kernel path against plain path: bf16 activations through 22
# layers; max abs difference relative to the largest plain logit.
MODEL_RTOL = 5e-2
# Train loss and gradients, kernel path against plain path (bf16, 22 layers):
# loss relative difference, and each gradient's max abs difference relative
# to its largest plain element (bf16 activations and gradients: a few ulps).
# The loss is a mean over 4096 tokens of fp32 log-sum-exps, so bf16 rounding
# in the attention moves it far less than one ulp of bf16 (3.9e-3).
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 5e-2

FLASH_SRC = "ray_tpu_torch/csrc/flash_fwd.cu"
BWD_SRC = "ray_tpu_torch/csrc/flash_bwd.cu"
PAGED_SRC = "ray_tpu_torch/csrc/paged_attention.cu"
# the training path's attention shape: llama_1b at batch 8, sequence 2048
TRAIN_ATTN = (8, 2048, 2048, 16, 4, 128, True)
# the ViT train step's: ViT-L/16 at 224 px (196 patches), batch 32, 16 heads
# of 64, not causal
VIT_ATTN = (32, 196, 196, 16, 16, 64, False)
# the dispatchers' counts of calls sent to a plain version (_kernels.py)
PLAIN_COUNTS = ("attention_plain", "paged_attention_plain")
# Sharded against unsharded llama_1b loss at world size 1 (mesh (b)): the
# same kernels on the same bf16 tensors; the loss passes through the
# sharded CE's per-rank sum and count, so allow rounding of a mean over 4096
# tokens, far under one bf16 ulp.
MESH_LOSS_RTOL = 1e-3
# MoE in bf16 against fp32 on the same bf16-rounded inputs (mesh (e)): max
# abs difference relative to the largest fp32 output; bf16 products over
# hidden 2048 and ffn 8192 leave a few bf16 ulps (2^-8 = 3.9e-3 each).
MOE_RTOL = 5e-2


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def require_no_plain(counts, where: str) -> None:
    plain = {n: counts.get(n, 0) for n in PLAIN_COUNTS}
    require(not any(plain.values()), f"{where}: calls ran plain versions: {plain}")


def close_ratio(out, ref) -> float:
    """max |out - ref| / (ATOL + RTOL |ref|): the check passes at <= 1."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (KERNEL_ATOL + KERNEL_RTOL * ref.abs())).max().item()


def bound_ms(flops: float, nbytes: float, peaks):
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(torch, fn, arg_sets, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` calls, timed with CUDA events. Calls
    cycle over ``arg_sets`` (separate copies of the inputs, together larger
    than the 50 MB L2) so each call finds its inputs cold, as on the path."""
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, arg_sets, iters: int = 20, replays: int = 5) -> float:
    """Mean ms per call of ``iters`` calls (cycling over ``arg_sets``) captured
    once in a CUDA graph, replayed ``replays`` times between CUDA events: the
    device's time, without the host's cost of each launch."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


# --------------------------------------------------------------------------- #
def phase_device(ctx):
    import torch

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.bench import peaks_for

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    ctx["smi"] = smi.stdout.strip().splitlines()[0]
    print(ctx["smi"], flush=True)
    ctx["card"] = torch.cuda.get_device_name(0)
    ctx["peaks_key"], ctx["peaks"] = peaks_for(ctx["card"])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; card {ctx['card']}; "
          f"bounds from {ctx['peaks_key']} peaks {ctx['peaks']}", flush=True)
    secs = _kernels.build_all()
    ctx["build_s"] = secs
    print(f"kernel build: {secs:.1f} s", flush=True)
    for name in ("flash_fwd", "flash_bwd", "paged_attention"):
        for line in _kernels.build_log(name).splitlines():
            if ("registers" in line or "spill" in line or "entry function" in line
                    or "error" in line.lower()):
                print(f"  ptxas {name}: {line.strip()}", flush=True)


def _flash_case(torch, b, sq, skv, hq, hkv, d, causal, seed, copies=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = []
    for _ in range(copies):
        q = torch.randn((b, sq, hq, d), generator=g, device="cuda").to(torch.bfloat16)
        k = torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
        v = torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
        sets.append((q, k, v))
    return sets


def _visible_pairs(sq, skv, causal):
    if not causal:
        return sq * skv
    off = skv - sq
    return sum(min(off + i + 1, skv) for i in range(sq))


def phase_kernels(ctx):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.models import paged_decode as pd
    from ray_tpu_torch.ops.attention import flash_attention, reference_attention

    peaks = ctx["peaks"]
    # ---- K1: flash forward -------------------------------------------------
    cases = [  # (b, sq, skv, hq, hkv, d, causal)
        (8, 512, 512, 16, 4, 128, True),   # prefill at llama_1b, largest bucket
        (2, 100, 300, 16, 4, 128, True),   # ragged, Sq < Skv (bottom-right causal)
        (2, 200, 333, 8, 2, 64, False),    # non-causal, ragged, head_dim 64
        (2, 300, 700, 16, 4, 128, True),   # causal offset 400: not a multiple of the tiles
    ]
    errs = []
    for i, (b, sq, skv, hq, hkv, d, causal) in enumerate(cases):
        (q, k, v), = _flash_case(torch, b, sq, skv, hq, hkv, d, causal, seed=10 + i)
        out = flash_attention(q, k, v, causal=causal)
        ref = reference_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ratio = close_ratio(out, ref)
        require(bool(torch.isfinite(out).all()), f"flash_fwd case {cases[i]}: non-finite output")
        print(f"flash_fwd {cases[i]}: max_abs_err {err:.3e}, worst error / (atol {KERNEL_ATOL} "
              f"+ rtol {KERNEL_RTOL} |plain|) = {ratio:.3f} (must be <= 1)", flush=True)
        require(ratio <= 1.0, f"flash_fwd case {cases[i]} disagrees: ratio {ratio}")
        errs.append(err)
    b, sq, skv, hq, hkv, d, causal = cases[0]
    sets = _flash_case(torch, b, sq, skv, hq, hkv, d, causal, seed=20, copies=4)
    ms = cuda_ms(torch, lambda q, k, v: flash_attention(q, k, v, causal=True), sets)
    plain = cuda_ms(torch, lambda q, k, v: reference_attention(q, k, v, causal=True), sets,
                    iters=5)
    lib = cuda_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
        enable_gqa=True), sets)
    flops = 4.0 * b * hq * d * _visible_pairs(sq, skv, causal)
    nbytes = 2.0 * (2 * b * sq * hq * d + 2 * b * skv * hkv * d)
    bms, by = bound_ms(flops, nbytes, peaks)
    ctx["k1"] = {"name": "flash_fwd", "route": "cuda", "source": FLASH_SRC,
                 "replaces": "ray_tpu/ops/attention.py:71", "max_abs_err": max(errs),
                 "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                 "library_ms": lib, "shape": list(cases[0])}
    print(f"flash_fwd {cases[0]}: {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, "
          f"bound {bms:.4f} ms ({by}) on {ctx['card']}", flush=True)

    # ---- K4: paged decode attention ----------------------------------------
    ctx["k4"] = _paged_attention_kernel(ctx)

    # ---- K1', K2, K3: the training path's attention kernels -----------------
    _train_attention_kernels(ctx)


def _paged_attention_kernel(ctx):
    """K4 at two shapes, each against its plain version and timed three ways:
    ``ms`` (20 wrapper calls between CUDA events, as for the other kernels),
    ``device_ms`` (the same 20 calls captured once in a CUDA graph and
    replayed: the device's time alone) and, at the serving shape, ``host_us``
    (host clock over 200 wrapper calls with no synchronisation in between)."""
    import torch

    from ray_tpu_torch.models import paged_decode as pd

    peaks = ctx["peaks"]
    nh, nkv, D, ps, max_pages = 16, 4, 128, 64, 32

    def paged_inputs(seed, B, lo, hi, total_pages, trash_slots):
        g = torch.Generator().manual_seed(seed)
        slot_pages = (total_pages - 1) // B
        lengths = torch.randint(lo, hi + 1, (B,), generator=g, dtype=torch.int32)
        lengths[:trash_slots] = 1             # inactive-like slots: all-trash table rows
        perm = torch.randperm(total_pages - 1, generator=g) + 1
        table = torch.zeros((B, max_pages), dtype=torch.int32)
        for s in range(trash_slots, B):
            n = -(-int(lengths[s]) // ps)
            table[s, :n] = perm[s * slot_pages: s * slot_pages + n]
        gd = torch.Generator(device="cuda").manual_seed(seed)
        kp = torch.randn((nkv, total_pages, ps, D), generator=gd, device="cuda").to(torch.bfloat16)
        vp = torch.randn((nkv, total_pages, ps, D), generator=gd, device="cuda").to(torch.bfloat16)
        q = (torch.randn((B, nh, D), generator=gd, device="cuda") * D ** -0.5).to(torch.bfloat16)
        return q, kp, vp, table.cuda(), lengths.cuda()

    # (a) the serve phase's engine: 64 slots, page size 64, 513 pages, and a
    # block table as wide as max_seq_len / page_size = 2048 / 64 = 32 pages;
    # slots hold 1..512 rows (at most 8 pages each, 512 real pages in all).
    # (b) few slots, long contexts, the case splitting over the sequence is
    # for: 4 slots of 1537..2048 rows on the same 32-page table.
    shapes = {"": (64, 1, 512, 513, 4, 30), "_long": (4, 1537, 2048, 129, 0, 31)}
    entry = {"name": "paged_attention", "route": "cuda", "source": PAGED_SRC,
             "replaces": "ray_tpu/models/paged_decode.py:93", "library_ms": None}
    errs = []
    for suffix, (B, lo, hi, total_pages, trash, seed) in shapes.items():
        args = paged_inputs(seed, B, lo, hi, total_pages, trash)
        out = pd.paged_attention(*args)
        ref = pd._paged_attention_reference(*args, 1.0)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ratio = close_ratio(out, ref)
        require(bool(torch.isfinite(out).all()), f"paged_attention B{B}: non-finite output")
        print(f"paged_attention (B{B} nh{nh} nkv{nkv} D{D} ps{ps}, lengths {lo}..{hi}): "
              f"max_abs_err {err:.3e}, worst error / (atol {KERNEL_ATOL} + rtol {KERNEL_RTOL} "
              f"|plain|) = {ratio:.3f} (must be <= 1)", flush=True)
        require(ratio <= 1.0, f"paged_attention B{B} disagrees: ratio {ratio}")
        errs.append(err)
        del args, out, ref
        sets = [paged_inputs(40 + 10 * len(suffix) + i, B, lo, hi, total_pages, trash)
                for i in range(4)]
        ms = cuda_ms(torch, pd.paged_attention, sets)
        dev_ms = graph_ms(torch, pd.paged_attention, sets)
        rows = sum(int(s[4].sum()) for s in sets) / len(sets)  # K/V rows this data reads
        flops = 4.0 * nh * D * rows
        nbytes = 2.0 * (2 * B * nh * D + 2 * rows * nkv * D) + 4.0 * (B * max_pages + B)
        bms, by = bound_ms(flops, nbytes, peaks)
        splits = pd.split_count(B, nkv, max_pages, ps, pd._sm_count(0))
        entry.update({f"ms{suffix}": ms, f"device_ms{suffix}": dev_ms, f"bound_ms{suffix}": bms,
                      f"shape{suffix}": [B, nh, nkv, D, ps, max_pages, lo, hi]})
        line = (f"paged_attention B{B} lengths {lo}..{hi}, {splits} split(s) a slot by "
                f"split_count: {ms:.5f} "
                f"ms, device (graph) {dev_ms:.5f} ms")
        if not suffix:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(200):
                pd.paged_attention(*sets[i % len(sets)])
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            plain = cuda_ms(torch, lambda *a: pd._paged_attention_reference(*a, 1.0), sets,
                            iters=5)
            entry.update({"host_us": host_us, "plain_ms": plain, "bound_by": by})
            line += f", host {host_us:.2f} us a call, plain {plain:.5f} ms"
        print(f"{line}, bound {bms:.5f} ms ({by}: {nbytes / 1e6:.3f} MB) on {ctx['card']}",
              flush=True)
        del sets
        torch.cuda.empty_cache()
    entry["max_abs_err"] = max(errs)
    return entry


def _grad_ratio(out, ref) -> float:
    """max |out - ref| / (GRAD_ATOL max|ref| + RTOL |ref|): passes at <= 1."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (GRAD_ATOL * ref.abs().max() + KERNEL_RTOL * ref.abs())).max().item()


def grad_leaves(params):
    """(names, leaves) of llama parameters in train.step._leaves' order, each
    leaf set to take a gradient."""
    from ray_tpu_torch.train.step import _leaves

    names = []
    for key in sorted(params):
        names += ([f"layers.{n}" for n in sorted(params["layers"])] if key == "layers" else [key])
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return names, leaves


def compare_grads(torch, where: str, names, grads_k, grads_p) -> float:
    """Prints max|diff|/max|plain| of every gradient, kernels against plain,
    and fails on a non-finite one or one beyond TRAIN_GRAD_RTOL; returns the
    worst."""
    worst = 0.0
    for name, gk, gp in zip(names, grads_k, grads_p):
        require(bool(torch.isfinite(gk).all()), f"{where}: non-finite gradient {name}")
        rel = ((gk.float() - gp.float()).abs().max() / gp.float().abs().max()).item()
        print(f"  grad {name} {tuple(gk.shape)}: max|diff|/max|plain| {rel:.3e} "
              f"(tol {TRAIN_GRAD_RTOL})", flush=True)
        worst = max(worst, rel)
    require(worst <= TRAIN_GRAD_RTOL, f"{where} gradients disagree: {worst} > {TRAIN_GRAD_RTOL}")
    return worst


def require_no_launches(counts, where: str) -> None:
    require(not any(counts.values()), f"{where} plain path launched kernels: {dict(counts)}")


def _train_attention_kernels(ctx):
    """K1' (forward with lse), K2 (dQ) and K3 (dK/dV) at llama_1b's training
    shape, at two ragged Sq < Skv cases and at ViT-L/16's shape (D64, one q
    head per kv head, not causal): each against its plain version on the
    same inputs (the kernels' own lse and delta feed both backward
    versions). Then each is timed at the two train steps' shapes."""
    import torch

    from ray_tpu_torch.ops import attention as ta

    errs = {"k1l": [], "k2": [], "k3": []}
    for i, case in enumerate((TRAIN_ATTN, (2, 100, 300, 16, 4, 128, True),
                              (2, 300, 700, 16, 4, 128, True), VIT_ATTN)):
        b, sq, skv, hq, hkv, d, causal = case
        scale = d ** -0.5
        (q, k, v), = _flash_case(torch, b, sq, skv, hq, hkv, d, causal, seed=50 + i)
        g = torch.Generator(device="cuda").manual_seed(60 + i)
        dout = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
        out, lse, out_lo = ta.flash_attention_lse(q, k, v, causal)
        delta = ta._delta(out, dout, out_lo)
        dq = ta.flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
        dk, dv = ta.flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale)
        torch.cuda.synchronize()
        for t in (out, lse, out_lo, dq, dk, dv):
            require(bool(torch.isfinite(t).all()), f"attention kernels {case}: non-finite output")
        # out_lo, the rounding residual of out: within half a bf16 ulp of out
        require(bool((out_lo.float().abs() <= 2 ** -7 * out.float().abs()).all()),
                f"flash_fwd_lse {case}: out_lo is not out's rounding residual")
        ref_out, ref_lse, ref_lo = ta.reference_attention_lse(q, k, v, causal)
        o32, ref_o32 = out.float() + out_lo.float(), ref_out.float() + ref_lo.float()
        checks = [("flash_fwd_lse out", "k1l", out, ref_out, close_ratio(out, ref_out)),
                  ("flash_fwd_lse out + out_lo", "k1l", o32, ref_o32, close_ratio(o32, ref_o32)),
                  ("flash_fwd_lse lse", "k1l", lse, ref_lse,
                   ((lse - ref_lse).abs() / (LSE_ATOL + LSE_RTOL * ref_lse.abs())).max().item())]
        del ref_out, ref_lse, ref_lo, o32, ref_o32
        ref_dq = ta.flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal, scale)
        checks.append(("flash_bwd_dq dq", "k2", dq, ref_dq, _grad_ratio(dq, ref_dq)))
        del ref_dq
        ref_dk, ref_dv = ta.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal, scale)
        checks += [("flash_bwd_dkv dk", "k3", dk, ref_dk, _grad_ratio(dk, ref_dk)),
                   ("flash_bwd_dkv dv", "k3", dv, ref_dv, _grad_ratio(dv, ref_dv))]
        for what, key, got, ref, ratio in checks:
            err = (got.float() - ref.float()).abs().max().item()
            tol = (f"atol {LSE_ATOL} + rtol {LSE_RTOL} |plain|" if what.endswith("lse") else
                   f"atol {KERNEL_ATOL} + rtol {KERNEL_RTOL} |plain|" if key == "k1l" else
                   f"{GRAD_ATOL} max|plain| + rtol {KERNEL_RTOL} |plain|")
            print(f"{what} {case}: max_abs_err {err:.3e}, worst error / ({tol}) = {ratio:.3f} "
                  "(must be <= 1)", flush=True)
            require(ratio <= 1.0, f"{what} {case} disagrees with its plain version: {ratio}")
            errs[key].append(err)
        del checks, ref_dk, ref_dv
        torch.cuda.empty_cache()

    meta = {"k1l": ("flash_fwd_lse", FLASH_SRC, "ray_tpu/ops/attention.py:155"),
            "k2": ("flash_bwd_dq", BWD_SRC, "ray_tpu/ops/attention.py:182"),
            "k3": ("flash_bwd_dkv", BWD_SRC, "ray_tpu/ops/attention.py:224")}
    for suffix, shape in (("", TRAIN_ATTN), ("_vit", VIT_ATTN)):
        timed = _time_train_attention(ctx, shape)
        for key, (name, src, replaces) in meta.items():
            ms, plain, lib, bms, by = timed[key]
            entry = ctx.setdefault(key, {"name": name, "route": "cuda", "source": src,
                                         "replaces": replaces, "max_abs_err": max(errs[key])})
            entry.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain,
                          f"bound_ms{suffix}": bms, f"bound_by{suffix}": by,
                          f"library_ms{suffix}": lib, f"shape{suffix}": list(shape)})


def _time_train_attention(ctx, shape):
    """{kernel key: (ms, plain_ms, library_ms, bound_ms, bound_by)} of K1',
    K2 and K3 at ``shape``; the library yardsticks are SDPA's forward and
    SDPA's whole backward."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as ta

    peaks = ctx["peaks"]
    b, sq, skv, hq, hkv, d, causal = shape
    scale = d ** -0.5
    sets = []
    for i, (q, k, v) in enumerate(_flash_case(torch, *shape, seed=70, copies=2)):
        g = torch.Generator(device="cuda").manual_seed(80 + i)
        dout = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
        out, lse, out_lo = ta.flash_attention_lse(q, k, v, causal)
        sets.append((q, k, v, dout, lse, ta._delta(out, dout, out_lo)))
    times = {
        "k1l": (cuda_ms(torch, lambda q, k, v, *_: ta.flash_attention_lse(q, k, v, causal), sets),
                cuda_ms(torch, lambda q, k, v, *_: ta.reference_attention_lse(q, k, v, causal),
                        sets, iters=3, warmup=1)),
        "k2": (cuda_ms(torch, lambda *a: ta.flash_bwd_dq(*a, causal, scale), sets),
               cuda_ms(torch, lambda *a: ta.flash_bwd_dq_reference(*a, causal, scale), sets,
                       iters=3, warmup=1)),
        "k3": (cuda_ms(torch, lambda *a: ta.flash_bwd_dkv(*a, causal, scale), sets),
               cuda_ms(torch, lambda *a: ta.flash_bwd_dkv_reference(*a, causal, scale), sets,
                       iters=3, warmup=1)),
    }
    # library yardsticks, timed only: SDPA forward, and SDPA's backward alone
    # (dq, dk and dv together) on a graph built once per input set
    sdpa_fwd = cuda_ms(torch, lambda q, k, v, *_: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
        enable_gqa=True), sets)
    graphs = []
    for q, k, v, dout, _, _ in sets:
        leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
        graphs.append((o, leaves, dout.transpose(1, 2)))
    sdpa_bwd = cuda_ms(torch, lambda o, leaves, g: torch.autograd.grad(
        o, leaves, g, retain_graph=True), graphs)
    del graphs, sets
    torch.cuda.empty_cache()

    pairs = _visible_pairs(sq, skv, causal)
    q_el, kv_el, rows = b * sq * hq * d, b * skv * hkv * d, b * hq * sq
    work = {  # (flops, bytes): each input read once, each output written once
        "k1l": (4.0 * b * hq * d * pairs, 2.0 * (3 * q_el + 2 * kv_el) + 4.0 * rows),
        "k2": (6.0 * b * hq * d * pairs, 2.0 * (3 * q_el + 2 * kv_el) + 8.0 * rows),
        "k3": (8.0 * b * hq * d * pairs, 2.0 * (2 * q_el + 4 * kv_el) + 8.0 * rows),
    }
    names = {"k1l": "flash_fwd_lse", "k2": "flash_bwd_dq", "k3": "flash_bwd_dkv"}
    result = {}
    for key, (ms, plain) in times.items():
        lib = sdpa_fwd if key == "k1l" else sdpa_bwd
        bms, by = bound_ms(*work[key], peaks)
        result[key] = (ms, plain, lib, bms, by)
        print(f"{names[key]} {shape}: {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
              f"bound {bms:.4f} ms ({by}: {work[key][0] / 1e9:.2f} GFLOP, "
              f"{work[key][1] / 1e9:.4f} GB) on {ctx['card']}", flush=True)
    print(f"library yardsticks at {shape}: SDPA forward {sdpa_fwd:.4f} ms (for flash_fwd_lse); "
          f"SDPA backward {sdpa_bwd:.4f} ms computes dq, dk and dv together (for flash_bwd_dq "
          f"+ flash_bwd_dkv: {times['k2'][0] + times['k3'][0]:.4f} ms)", flush=True)
    return result


def _llama_1b():
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.llama_1b(max_seq_len=2048, attention_impl="flash")


def phase_model(ctx):
    import torch

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.models import paged_decode as pd
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.ops import attention as attn_mod

    cfg = _llama_1b()
    params = ctx.setdefault("params", llama_init(cfg, seed=0, device="cuda"))
    ps, max_pages, bucket, ticks = 64, 8, 256, 4
    lens = [200, 77]
    g = torch.Generator().manual_seed(5)
    tokens = torch.zeros((2, bucket), dtype=torch.int32)
    for r, n in enumerate(lens):
        tokens[r, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=g, dtype=torch.int32)
    feed = torch.randint(0, cfg.vocab_size, (ticks, 3), generator=g, dtype=torch.int32)
    pages = [list(range(1, 1 + max_pages)), list(range(1 + max_pages, 1 + 2 * max_pages))]
    table = torch.zeros((3, max_pages), dtype=torch.int32)  # slot 2 inactive: trash rows
    table[0], table[1] = torch.tensor(pages[0]), torch.tensor(pages[1])

    def run():
        cache = pd.init_paged_cache(cfg, 1 + 2 * max_pages, ps, dtype=cfg.dtype, device="cuda")
        pg = torch.tensor([p[: bucket // ps] for p in pages], dtype=torch.int32, device="cuda")
        logits, cache = pd.paged_prefill(params, cache, tokens.cuda(), pg,
                                         torch.tensor(lens, dtype=torch.int32, device="cuda"),
                                         cfg, ps)
        outs = [logits]
        pos = torch.tensor(lens + [0], dtype=torch.int32, device="cuda")
        for t in range(ticks):
            step, cache = pd.paged_decode_one(params, cache, feed[t].cuda(), pos,
                                              table.cuda(), cfg, ps)
            outs.append(step[:2])
            pos = pos + torch.tensor([1, 1, 0], dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        return outs

    _kernels.reset_counts()
    kern = run()
    counts = dict(_kernels.launch_counts)
    require(counts.get("flash_fwd") == cfg.num_layers
            and counts.get("paged_attention") == cfg.num_layers * ticks,
            f"kernel run did not go through the kernels: {counts}")
    _kernels.reset_counts()
    with mock.patch.object(attn_mod, "flash_attention",
                           lambda q, k, v, causal=True, scale=None:
                           attn_mod.reference_attention(q, k, v, causal, scale)), \
            mock.patch.object(pd, "paged_attention",
                              lambda q, kp, vp, t, l: pd._paged_attention_reference(
                                  q, kp, vp, t, l, 1.0)):
        plain = run()
    require(not any(_kernels.launch_counts.values()),
            f"plain run launched kernels: {dict(_kernels.launch_counts)}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(kern, plain)):
        require(bool(torch.isfinite(a).all()), f"model step {i}: non-finite logits")
        rel = ((a - b).abs().max() / b.abs().max()).item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        print(f"model {'prefill' if i == 0 else f'decode tick {i}'}: logits {tuple(a.shape)} "
              f"max|diff|/max|plain| {rel:.3e} (tol {MODEL_RTOL}), argmax agree {agree:.2f}",
              flush=True)
        worst = max(worst, rel)
    require(worst <= MODEL_RTOL, f"kernel path logits disagree with plain: {worst} > {MODEL_RTOL}")
    ctx["model_rel_err"] = worst


def phase_serve(ctx):
    import torch

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = _llama_1b()
    params = ctx.pop("params", None) or llama_init(cfg, seed=0, device="cuda")
    n_req, max_tokens = 64, 64
    rng = torch.Generator().manual_seed(7)
    lens = [(32, 64, 128, 256)[i % 4] for i in range(n_req)]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in lens]
    engine = LLMEngine(cfg, params, device="cuda", paged=True, num_slots=64, page_size=64,
                       total_pages=513, decode_chunk=32, prefill_buckets=[64, 256, 512])
    try:
        # warm-up request (cuBLAS handles, allocator), then the counted run
        engine.generate(prompts[0], max_tokens=4, timeout=600)
        torch.cuda.synchronize()
        s0 = engine.stats()
        _kernels.reset_counts()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=n_req) as pool:
            futs = [pool.submit(engine.generate, p, max_tokens, None, 600) for p in prompts]
            results = [f.result() for f in futs]
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    require(not engine._thread.is_alive(), "engine thread did not stop")
    counts = {name: _kernels.launch_counts[name] for name in ("flash_fwd", "paged_attention")}
    require_no_plain(_kernels.launch_counts, "serve")
    s1 = engine.stats()
    programs = s1["prefill_programs"] - s0["prefill_programs"]
    ticks = s1["decode_steps"] - s0["decode_steps"]
    for r in results:
        require(len(r["tokens"]) == max_tokens, f"request returned {len(r['tokens'])} tokens")
        require(all(0 <= t < cfg.vocab_size for t in r["tokens"]), "token outside the vocab")
    L = cfg.num_layers
    require(counts["flash_fwd"] == L * programs,
            f"flash_fwd launches {counts['flash_fwd']} != {L} x {programs} prefill programs")
    require(counts["paged_attention"] == L * ticks,
            f"paged_attention launches {counts['paged_attention']} != {L} x {ticks} ticks")
    ttft = statistics.median(r["ttft_s"] for r in results)
    toks = sum(len(r["tokens"]) for r in results)
    ctx["serve"] = {"requests": n_req, "wall_s": wall, "req_per_s": n_req / wall,
                    "tok_per_s": toks / wall, "p50_ttft_s": ttft, "prefill_programs": programs,
                    "decode_ticks": ticks, "launches": counts}
    ctx["launches"] = counts
    print(f"serve on {ctx['card']} ({ctx['smi']}): {n_req} requests x {max_tokens} tokens in "
          f"{wall:.3f} s: {n_req / wall:.3f} req/s, {toks / wall:.1f} tok/s, "
          f"p50 TTFT {ttft * 1e3:.1f} ms; {programs} prefill programs, {ticks} decode ticks, "
          f"launches {counts}", flush=True)


def phase_train(ctx):
    import dataclasses
    import math

    import numpy as np
    import torch

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.bench import train_bench
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.ops import attention as ta

    torch.cuda.empty_cache()
    # (a) loss and gradients, kernels against the plain path: full llama_1b,
    # B2 (both paths' gradients stay allocated for the comparison)
    cfg = dataclasses.replace(_llama_1b(), remat="save_attn")
    params = tl.llama_init(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2048))).cuda()
    targets = torch.roll(tokens, -1, dims=1)
    names, leaves = grad_leaves(params)

    def grads():
        loss = tl.llama_loss(params, tokens, targets, cfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    _kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    loss_k, grads_k = grads()
    torch.cuda.synchronize()
    peak_k = torch.cuda.max_memory_allocated()
    counts = dict(_kernels.launch_counts)
    want = {"flash_fwd_lse": cfg.num_layers, "flash_bwd_dq": cfg.num_layers,
            "flash_bwd_dkv": cfg.num_layers}
    require_no_plain(counts, "train (a)")
    require(counts == want, f"kernel train step launched {counts}, expected {want}")
    _kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(ta, "flash_attention_lse", ta.reference_attention_lse), \
            mock.patch.object(ta, "flash_bwd", ta.flash_bwd_reference):
        loss_p, grads_p = grads()
    torch.cuda.synchronize()
    peak_p = torch.cuda.max_memory_allocated()
    require_no_launches(_kernels.launch_counts, "train (a)")
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    print(f"train (a) llama_1b, {cfg.num_layers} layers, B2 S2048, save_attn: loss "
          f"kernels {loss_k.item():.6f} plain {loss_p.item():.6f}, relative difference "
          f"{rel_loss:.3e} (tol {TRAIN_LOSS_RTOL}); max_memory_allocated kernels "
          f"{peak_k} B, plain {peak_p} B", flush=True)
    worst = compare_grads(torch, "train (a)", names, grads_k, grads_p)
    require(rel_loss <= TRAIN_LOSS_RTOL, f"train loss disagrees: {rel_loss}")
    del params, leaves, grads_k, grads_p, tokens, targets
    torch.cuda.empty_cache()

    # (b) the train step at full llama_1b, as ray_tpu_torch.bench measures it
    res = train_bench(steps=10, warmup=3)
    require_no_plain(res["launches"], "train (b)")
    L = _llama_1b().num_layers
    want = {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    for i, rec in enumerate(res["per_step"]):
        loss, gnorm = rec["loss"], rec["grad_norm"]
        print(f"train (b) step {i}: loss {loss:.6f} grad_norm {gnorm:.6f} launches "
              f"{dict(sorted(rec['launches'].items()))}", flush=True)
        require(math.isfinite(loss) and math.isfinite(gnorm), f"step {i}: non-finite metrics")
        require(rec["launches"] == want,
                f"step {i} launched {rec['launches']}, expected {want} and no other kernel "
                "(a second flash_fwd_lse per layer would mean save_attn re-ran the forward)")
    print(f"train (b) on {ctx['card']} ({ctx['smi']}): llama_1b ({res['model_params']} params), "
          f"22 layers, save_attn, B{res['batch']} S{res['seq']}: {res['step_ms']:.3f} ms/step, "
          f"{res['value']} tokens/s, MFU {res['mfu']} ({ctx['peaks_key']} bf16 peak), "
          f"max_memory_allocated {res['max_memory_allocated'] / 2**30:.3f} GiB, "
          f"launches over {res['steps']} steps {res['launches']}", flush=True)
    ctx["train"] = dict(res, rel_loss_a=rel_loss, rel_grad_a=worst, peak_a_kernels=peak_k,
                        peak_a_plain=peak_p)
    ctx["train_launches"] = res["launches"]
    torch.cuda.empty_cache()


def phase_rl(ctx):
    import math

    import numpy as np
    import torch

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.ops import attention as ta
    from ray_tpu_torch.rl import (GRPOConfig, GRPOTrainer, compute_group_advantages, grpo_loss,
                                  make_logprob_fn)
    from ray_tpu_torch.train.step import _leaves

    torch.cuda.empty_cache()
    # llama_1b as a GRPO user runs it: save_attn, attention_impl "auto" (the
    # dispatch rule decides), a 512-row context (prompts of up to 256 tokens
    # and 64 new ones), so the engine's KV pool (32 slots x 512 rows, 0.74
    # GB) sits beside the trainer's parameters, reference copy, moments and
    # gradients (5 x 2.2 GB)
    cfg = tl.LlamaConfig.llama_1b(max_seq_len=512, remat="save_attn")
    grpo = GRPOConfig()
    L, V = cfg.num_layers, cfg.vocab_size
    # (a) GRPO loss and gradients at B8 S320 (not a multiple of the kernels'
    # 128-row tiles), kernels against the plain path. The policy and a
    # distinct frozen reference policy are random from seeds 0 and 1, so the
    # KL term and its gradient are not 0. Each path computes its own old and
    # reference logprobs through make_logprob_fn, as a trainer does: the
    # rollout policy is the policy, so the ratio is 1 on both paths. K1 and
    # K1' are one kernel, with and without the lse output, so the plain path
    # takes one plain forward for both (reference_attention_lse): a second
    # plain forward would differ from it by bf16 rounding, and the ratio
    # (exp of a difference of two logprobs near -10) would carry that noise.
    params = tl.llama_init(cfg, seed=0, device="cuda")
    ref_params = tl.llama_init(cfg, seed=1, device="cuda")
    rng = np.random.default_rng(2)
    n, seq = 8, 320
    tokens = torch.from_numpy(rng.integers(0, V, (n, seq))).cuda()
    mask = np.zeros((n, seq - 1), np.float32)
    prompt_lens = rng.integers(32, 257, n)
    for i, p in enumerate(prompt_lens):
        mask[i, p - 1:] = 1.0  # position t predicts token t + 1
    mask = torch.from_numpy(mask).cuda()
    rewards = torch.from_numpy(rng.random((n // grpo.group_size, grpo.group_size),
                                          dtype=np.float32))
    advantages = compute_group_advantages(rewards).reshape(-1).cuda()
    logprob = make_logprob_fn(cfg)
    names, leaves = grad_leaves(params)

    def update():
        old, ref = logprob(params, tokens), logprob(ref_params, tokens)
        with torch.enable_grad():
            loss, aux = grpo_loss(params, tokens, mask, advantages, old, ref, cfg,
                                  grpo.clip_eps, grpo.kl_coef)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.item() for k, v in aux.items()}, grads, old

    _kernels.reset_counts()
    loss_k, aux_k, grads_k, old_k = update()
    torch.cuda.synchronize()
    counts = dict(_kernels.launch_counts)
    want = {"flash_fwd": 2 * L, "flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    require_no_plain(counts, "rl (a)")
    require(counts == want, f"rl (a) kernel path launched {counts}, expected {want}")
    _kernels.reset_counts()
    with mock.patch.object(ta, "flash_attention",
                           lambda q, k, v, causal=True, scale=None:
                           ta.reference_attention_lse(q, k, v, causal, scale)[0]), \
            mock.patch.object(ta, "flash_attention_lse", ta.reference_attention_lse), \
            mock.patch.object(ta, "flash_bwd", ta.flash_bwd_reference):
        loss_p, aux_p, grads_p, old_p = update()
    torch.cuda.synchronize()
    require_no_launches(_kernels.launch_counts, "rl (a)")
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    rel_terms = {k: abs(aux_k[k] - aux_p[k]) / abs(aux_p[k]) for k in ("pg_loss", "kl")}
    lp_diff = (old_k - old_p).abs().max().item()
    print(f"rl (a) llama_1b, {L} layers, B{n} S{seq}, prompts {int(prompt_lens.min())}.."
          f"{int(prompt_lens.max())}, save_attn: loss kernels {loss_k.item():.6f} plain "
          f"{loss_p.item():.6f}, relative difference {rel_loss:.3e} (tol {TRAIN_LOSS_RTOL}); "
          f"kernels {aux_k}, plain {aux_p}, relative differences {rel_terms}; old logprobs "
          f"max|kernels - plain| {lp_diff:.3e}",
          flush=True)
    worst = compare_grads(torch, "rl (a)", names, grads_k, grads_p)
    require(rel_loss <= TRAIN_LOSS_RTOL, f"rl (a) GRPO loss disagrees: {rel_loss}")
    # the ratio is 1 on both paths, so pg_loss is mostly -sum(adv * mask) /
    # denom and does not read the kernels: the KL term is held on its own
    require(rel_terms["kl"] <= TRAIN_LOSS_RTOL, f"rl (a) KL disagrees: {rel_terms['kl']}")
    ctx["rl"] = {"a": {"loss_kernels": loss_k.item(), "loss_plain": loss_p.item(),
                       "rel_loss": rel_loss, "rel_grad": worst, "logprob_max_abs_diff": lp_diff,
                       "aux_kernels": aux_k, "aux_plain": aux_p, "launches": counts}}
    del params, ref_params, leaves, grads_k, grads_p, old_k, old_p
    torch.cuda.empty_cache()

    # (b) GRPOTrainer: 3 train_steps, GRPOConfig() defaults (group 4, 64 new
    # tokens, temperature 1.0, kl 0.02, 1 epoch), 32 slots, 8 prompts of
    # 32..256 tokens; the reward is the share of completion tokens below
    # vocab_size // 2
    steps = 3
    prompts = [rng.integers(0, V, int(rng.integers(32, 257))).tolist() for _ in range(8)]

    def reward(prompt, completion):
        return sum(1 for t in completion if t < V // 2) / max(1, len(completion))

    trainer = GRPOTrainer(cfg, reward, grpo=grpo, num_slots=32, device="cuda")
    seconds = {"rollout": 0.0, "logprobs": 0.0, "update": 0.0}
    completions = []

    def timed(key, fn, keep=None):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seconds[key] += time.perf_counter() - t0
            if keep is not None:
                keep.extend(out[0])
            return out
        return call

    trainer._rollout = timed("rollout", trainer._rollout, completions)
    trainer._logprob = timed("logprobs", trainer._logprob)
    trainer._step = timed("update", trainer._step)
    per_step = []
    try:
        s0 = trainer.engine.stats()
        _kernels.reset_counts()
        t_run = time.perf_counter()
        for i in range(steps):
            before = dict(seconds)
            t0 = time.perf_counter()
            m = trainer.train_step(prompts)
            wall = time.perf_counter() - t0
            split = {k: seconds[k] - before[k] for k in seconds}
            per_step.append(dict(m, wall_s=wall, **{f"{k}_s": v for k, v in split.items()}))
            print(f"rl (b) step {i}: {wall:.3f} s (rollout {split['rollout']:.3f} s, logprobs "
                  f"{split['logprobs']:.3f} s, update {split['update']:.3f} s); "
                  + ", ".join(f"{k} {v:.6g}" for k, v in m.items()), flush=True)
            require(all(math.isfinite(v) for v in m.values()), f"rl (b) step {i}: {m}")
        t_run = time.perf_counter() - t_run
        counts = dict(_kernels.launch_counts)
        s1 = trainer.engine.stats()
    finally:
        trainer.stop()
    require(not trainer.engine._thread.is_alive(), "rl (b): engine thread did not stop")
    require(len(completions) == steps * len(prompts) * grpo.group_size,
            f"rl (b): {len(completions)} completions")
    for c in completions:
        require(len(c) == grpo.max_new_tokens and all(0 <= t < V for t in c),
                f"rl (b): a completion of {len(c)} tokens, or outside the vocab")
    programs = s1["prefill_programs"] - s0["prefill_programs"]
    ticks = s1["decode_steps"] - s0["decode_steps"]
    updates = steps * grpo.epochs_per_batch
    # save_attn keeps the flash op's outputs: one lse forward, dQ and dK/dV
    # a layer per update, and no second forward in the backward
    want = {"flash_fwd": L * (programs + 2 * steps), "paged_attention": L * ticks,
            "flash_fwd_lse": L * updates, "flash_bwd_dq": L * updates,
            "flash_bwd_dkv": L * updates}
    require_no_plain(counts, "rl (b)")
    require(counts == want, f"rl (b) launched {counts}, expected {want} ({programs} prefill "
            f"programs, {ticks} decode ticks, {updates} updates)")
    fresh = tl.llama_init(cfg, seed=0, device="cuda")  # the trainer's initial weights
    require(all(torch.equal(a, b) for a, b in zip(_leaves(trainer._ref_params), _leaves(fresh))),
            "rl (b): the reference policy moved")
    moved = sum(int((a != b).sum()) for a, b in zip(_leaves(trainer.state.params),
                                                   _leaves(fresh)))
    require(moved > 0, "rl (b): the policy never moved")
    print(f"rl (b) on {ctx['card']} ({ctx['smi']}): llama_1b, {steps} GRPO steps of "
          f"{len(prompts)} prompts x {grpo.group_size} x {grpo.max_new_tokens} tokens in "
          f"{t_run:.3f} s: rollout {seconds['rollout']:.3f} s, logprobs "
          f"{seconds['logprobs']:.3f} s, update {seconds['update']:.3f} s; {programs} prefill "
          f"programs, {ticks} decode ticks, launches {counts}; {moved} of "
          f"{cfg.num_params} policy weights moved, the reference policy bitwise unchanged",
          flush=True)
    ctx["rl"]["b"] = {"steps": per_step, "seconds": seconds, "wall_s": t_run,
                      "prefill_programs": programs, "decode_ticks": ticks, "launches": counts,
                      "weights_moved": moved}
    del trainer, fresh
    torch.cuda.empty_cache()


def phase_vit(ctx):
    import math

    import numpy as np
    import torch

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.models import vit as tv
    from ray_tpu_torch.ops import attention as ta
    from ray_tpu_torch.train.step import adamw

    torch.cuda.empty_cache()
    # ViT-L/16 as tools/bench_data_train.py trains the JAX one: 224 px (196
    # patches), 1000 classes, bf16, batch 32, optax.adamw(1e-3); attention
    # "auto" (the dispatch rule decides); random weights and images from seeds
    cfg = tv.ViTConfig.vit_l(image_size=224)
    L, batch = cfg.num_layers, 32
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((batch, 224, 224, 3), dtype=np.float32)).cuda()
    labels = torch.from_numpy(rng.integers(0, cfg.num_classes, batch)).cuda()
    kernels_step = {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}

    # (a) loss and every gradient, kernels against the plain path
    params = tv.vit_init(cfg, seed=0, device="cuda")
    names, leaves = grad_leaves(params)

    def grads():
        loss = tv.vit_loss(params, images, labels, cfg)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    _kernels.reset_counts()
    loss_k, grads_k = grads()
    torch.cuda.synchronize()
    counts = dict(_kernels.launch_counts)
    require_no_plain(counts, "vit (a)")
    require(counts == kernels_step, f"vit (a) launched {counts}, expected {kernels_step}")
    _kernels.reset_counts()
    with mock.patch.object(ta, "flash_attention_lse", ta.reference_attention_lse), \
            mock.patch.object(ta, "flash_bwd", ta.flash_bwd_reference):
        loss_p, grads_p = grads()
    torch.cuda.synchronize()
    require_no_launches(_kernels.launch_counts, "vit (a)")
    rel_loss = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    print(f"vit (a) ViT-L/16, {L} layers, B{batch} 224 px: loss kernels {loss_k.item():.6f} "
          f"plain {loss_p.item():.6f}, relative difference {rel_loss:.3e} "
          f"(tol {TRAIN_LOSS_RTOL})", flush=True)
    worst = compare_grads(torch, "vit (a)", names, grads_k, grads_p)
    require(rel_loss <= TRAIN_LOSS_RTOL, f"vit (a) loss disagrees: {rel_loss}")
    truth = _vit_truth_distances(cfg, params, images, labels, names,
                                 {"kernels": grads_k, "plain": grads_p})
    del grads_k, grads_p, leaves

    # (b) one no-grad forward: the forward kernel once a layer, and logits
    # that agree with the plain forward's
    _kernels.reset_counts()
    with torch.no_grad():
        logits = tv.vit_forward(params, images, cfg)
    torch.cuda.synchronize()
    counts = dict(_kernels.launch_counts)
    require_no_plain(counts, "vit (b)")
    require(counts == {"flash_fwd": L}, f"vit (b) launched {counts}, expected flash_fwd {L}")
    with mock.patch.object(ta, "flash_attention",
                           lambda q, k, v, causal=True, scale=None:
                           ta.reference_attention(q, k, v, causal, scale)), torch.no_grad():
        logits_p = tv.vit_forward(params, images, cfg)
    require(tuple(logits.shape) == (batch, cfg.num_classes) and logits.dtype == torch.float32
            and bool(torch.isfinite(logits).all()), "vit (b): logits of the wrong shape or "
            "non-finite")
    rel_logits = ((logits - logits_p).abs().max() / logits_p.abs().max()).item()
    print(f"vit (b) no-grad forward: logits {tuple(logits.shape)}, max|diff|/max|plain| "
          f"{rel_logits:.3e} (tol {MODEL_RTOL}), launches {counts}", flush=True)
    require(rel_logits <= MODEL_RTOL, f"vit (b) logits disagree: {rel_logits}")
    del params, logits, logits_p
    torch.cuda.empty_cache()

    # (c) the train step: 3 warm-up steps, then 10 timed
    step, init = tv.make_vit_train_step(cfg, adamw(1e-3))
    params, opt_state = init(seed=0, device="cuda")
    warmup, steps = 3, 10
    for _ in range(warmup):
        params, opt_state, loss = step(params, opt_state, images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_counts()
    per_step = []
    t0 = time.perf_counter()
    for _ in range(steps):
        before = dict(_kernels.launch_counts)
        params, opt_state, loss = step(params, opt_state, images, labels)
        per_step.append((loss, {n: c - before.get(n, 0) for n, c in _kernels.launch_counts.items()
                                if c != before.get(n, 0)}))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)
    require_no_plain(launches, "vit (c)")
    for i, (loss, counts) in enumerate(per_step):
        print(f"vit (c) step {i}: loss {loss.item():.6f} launches {dict(sorted(counts.items()))}",
              flush=True)
        require(math.isfinite(loss.item()), f"vit (c) step {i}: non-finite loss")
        require(counts == kernels_step, f"vit (c) step {i} launched {counts}, expected "
                f"{kernels_step} and no other kernel")
    step_ms, images_s = dt / steps * 1e3, batch * steps / dt
    peak = torch.cuda.max_memory_allocated()
    print(f"vit (c) on {ctx['card']} ({ctx['smi']}): ViT-L/16 ({cfg.num_params} params), {L} "
          f"layers, B{batch} 224 px, adamw(1e-3): {step_ms:.3f} ms/step, {images_s:.1f} "
          f"images/s, max_memory_allocated {peak / 2**30:.3f} GiB, launches over {steps} steps "
          f"{launches}", flush=True)
    ctx["vit"] = {"rel_loss_a": rel_loss, "rel_grad_a": worst, "truth_a": truth,
                  "rel_logits_b": rel_logits,
                  "step_ms": step_ms, "images_per_s": images_s, "batch": batch, "steps": steps,
                  "max_memory_allocated": peak, "launches": launches,
                  "losses": [loss.item() for loss, _ in per_step]}
    ctx["vit_launches"] = launches
    del params, opt_state
    torch.cuda.empty_cache()


def _vit_truth_distances(cfg, params, images, labels, names, paths):
    """Measurement, no check: each bf16 path's gradients against an fp32
    truth (the same weights in fp32, autograd through the plain forward),
    as max|diff|/max|truth| per attention weight. Besides the given paths,
    the kernels with delta from the bf16 out alone, as the JAX package
    takes it (no out_lo: the error out_lo removes), and attention_impl
    "reference" (autograd through the plain softmax in bf16)."""
    import dataclasses

    import torch

    from ray_tpu_torch.models import vit as tv
    from ray_tpu_torch.ops import attention as ta

    def grads(p, c):
        _, leaves = grad_leaves(p)
        return torch.autograd.grad(tv.vit_loss(p, images, labels, c), leaves)

    real_bwd = ta.flash_bwd
    with mock.patch.object(ta, "flash_bwd", lambda q, k, v, out, lse, dout, causal=True,
                           scale=None, out_lo=None: real_bwd(q, k, v, out, lse, dout, causal,
                                                             scale)):
        paths = dict(paths, kernels_delta_from_out=grads(params, cfg))
    paths["reference"] = grads(params, dataclasses.replace(cfg, attention_impl="reference"))
    p32 = {k: (v.detach().float() if torch.is_tensor(v)
               else {n: w.detach().float() for n, w in v.items()}) for k, v in params.items()}
    truth = grads(p32, dataclasses.replace(cfg, dtype=torch.float32, attention_impl="reference"))
    del p32
    out = {}
    for path, gs in paths.items():
        out[path] = {n: ((g.float() - t).abs().max() / t.abs().max()).item()
                     for n, g, t in zip(names, gs, truth) if n.split(".")[-1] in
                     ("wq", "wk", "wv", "wo", "head")}
        print(f"vit (a) {path} against the fp32 truth, max|diff|/max|truth|: "
              + ", ".join(f"{n} {e:.3e}" for n, e in out[path].items()), flush=True)
    del paths, truth
    torch.cuda.empty_cache()
    return out


def _mesh_first_collective(torch, mesh) -> float:
    """Seconds to the first placement on ``mesh`` and back to a whole tensor."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    t0 = time.perf_counter()
    x = distribute_tensor(torch.ones(4, 4, device="cuda"), mesh, [Replicate()] * mesh.ndim)
    x.full_tensor()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_mesh(ctx):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshConfig, make_mesh

    torch.cuda.empty_cache()
    # (a) a process group of world size 1 on NCCL, and the port's mesh on it
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        t0 = time.perf_counter()
        mesh = make_mesh(MeshConfig())
        built = time.perf_counter() - t0
        first = _mesh_first_collective(torch, mesh)
        t0 = time.perf_counter()
        mesh7 = DeviceMesh("cuda", [[[[[[[0]]]]]]], mesh_dim_names=AXIS_ORDER)
        built7 = time.perf_counter() - t0
        first7 = _mesh_first_collective(torch, mesh7)
        print(f"mesh (a): make_mesh(MeshConfig()) dims {mesh.mesh_dim_names} {tuple(mesh.shape)} "
              f"built in {built:.4f} s, first placement + gather {first:.4f} s; a seven-dim mesh "
              f"of size-1 dims built in {built7:.4f} s, first placement + gather {first7:.4f} s",
              flush=True)
        res = {"a": {"dims": list(mesh.mesh_dim_names), "build_s": built, "first_s": first,
                     "build7_s": built7, "first7_s": first7}}
        res.update(_mesh_llama(ctx, mesh))
        res.update(_mesh_ulysses_moe(ctx, mesh))
        ctx["mesh"] = res
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


def _mesh_llama(ctx, mesh):
    """mesh (b) and (c): llama_1b through the mesh against the unsharded port."""
    import dataclasses

    import numpy as np
    import torch

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, shard_pytree
    from ray_tpu_torch.train.step import (TrainState, default_optimizer, make_train_state_factory,
                                          make_train_step)

    # (b) loss and every gradient, sharded against unsharded, B2 S2048
    cfg = tl.LlamaConfig.llama_1b(max_seq_len=2048, remat="save_attn")
    L = cfg.num_layers
    kernels_step = {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    params = tl.llama_init(cfg, seed=0, device="cuda")
    sharded = shard_pytree(params, tl.llama_logical_axes(cfg), mesh, DEFAULT_LLM_RULES)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 2048))).cuda()
    targets = torch.roll(tokens, -1, dims=1)
    names, leaves = grad_leaves(params)
    _, sleaves = grad_leaves(sharded)

    def grads(p, lv, **kw):
        loss = tl.llama_loss(p, tokens, targets, cfg, **kw)
        return loss, torch.autograd.grad(loss, lv)

    _kernels.reset_counts()
    loss_m, grads_m = grads(sharded, sleaves, mesh=mesh)
    loss_m = loss_m.full_tensor().detach()
    grads_m = [g.full_tensor() for g in grads_m]
    torch.cuda.synchronize()
    counts = dict(_kernels.launch_counts)
    require_no_plain(counts, "mesh (b)")
    require(counts == kernels_step, f"mesh (b) sharded path launched {counts}, expected "
            f"{kernels_step}")
    loss_u, grads_u = grads(params, leaves)
    rel_loss = abs(loss_m.item() - loss_u.item()) / abs(loss_u.item())
    print(f"mesh (b) llama_1b, {L} layers, B2 S2048, save_attn: loss sharded "
          f"{loss_m.item():.6f} unsharded {loss_u.item():.6f}, relative difference "
          f"{rel_loss:.3e} (tol {MESH_LOSS_RTOL}); sharded launches {counts}", flush=True)
    worst = compare_grads(torch, "mesh (b)", names, grads_m, grads_u)
    require(rel_loss <= MESH_LOSS_RTOL, f"mesh (b) loss disagrees: {rel_loss}")
    out = {"b": {"loss_sharded": loss_m.item(), "loss_unsharded": loss_u.item(),
                 "rel_loss": rel_loss, "rel_grad": worst, "launches": counts}}
    del params, sharded, leaves, sleaves, grads_m, grads_u
    torch.cuda.empty_cache()

    # (c) the sharded train step at B8 S2048, in turns with the unsharded step
    # on the same tensors (at world size 1 a DTensor's local tensor is the
    # whole parameter)
    opt = default_optimizer(warmup_steps=10, total_steps=1000)
    state = make_train_state_factory(cfg, opt, mesh=mesh)(seed=0)
    local = lambda tree: {k: local(v) if isinstance(v, dict) else v.to_local()
                          for k, v in tree.items()}
    plain = TrainState(step=0, params=local(state.params),
                       opt_state=dataclasses.replace(state.opt_state, mu=local(state.opt_state.mu),
                                                     nu=local(state.opt_state.nu)))
    steps = {"sharded": make_train_step(cfg, opt, mesh=mesh), "unsharded": make_train_step(cfg, opt)}
    states = {"sharded": state, "unsharded": plain}
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 2048))).cuda()
    targets = torch.roll(tokens, -1, dims=1)

    def run(which):
        torch.cuda.synchronize()
        before = dict(_kernels.launch_counts)
        t0 = time.perf_counter()
        states[which], m = steps[which](states[which], tokens, targets)
        loss = m["loss"].item()  # waits for the step
        wall = time.perf_counter() - t0
        # the other path's state shares these tensors: keep its counts along
        states["unsharded" if which == "sharded" else "sharded"].opt_state.count = \
            states[which].opt_state.count
        launched = {n: c - before.get(n, 0) for n, c in _kernels.launch_counts.items()
                    if c != before.get(n, 0)}
        return {"loss": loss, "grad_norm": m["grad_norm"].item(), "ms": wall * 1e3,
                "launches": launched}

    for _ in range(3):
        run("sharded")
    run("unsharded")
    _kernels.reset_counts()
    timed = {"sharded": [], "unsharded": []}
    for which in ("sharded", "unsharded", "unsharded", "sharded") * 2 + ("sharded",):
        rec = run(which)
        timed[which].append(rec)
        print(f"mesh (c) {which} step: {rec['ms']:.3f} ms, "
              f"loss {rec['loss']:.6f} grad_norm {rec['grad_norm']:.6f} launches "
              f"{dict(sorted(rec['launches'].items()))}", flush=True)
        require(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
                f"mesh (c) {which}: non-finite metrics")
        require(rec["launches"] == kernels_step, f"mesh (c) {which} step launched "
                f"{rec['launches']}, expected {kernels_step} and no other kernel")
    launches = {n: c for n, c in _kernels.launch_counts.items() if c}
    require_no_plain(_kernels.launch_counts, "mesh (c)")
    med = {w: statistics.median(r["ms"] for r in recs) for w, recs in timed.items()}
    print(f"mesh (c) on {ctx['card']} ({ctx['smi']}): llama_1b, {L} layers, save_attn, B8 S2048, "
          f"world size 1: sharded {med['sharded']:.3f} ms/step over {len(timed['sharded'])} "
          f"steps, unsharded {med['unsharded']:.3f} ms/step over {len(timed['unsharded'])} "
          f"steps, in turns; the train phase's unsharded step {ctx['train']['step_ms']:.3f} ms",
          flush=True)
    # what the gap is made of: one more step of each under torch.profiler
    profiled = {w: _profiled_step(torch, lambda w=w: run(w)) for w in ("sharded", "unsharded")}
    out["c"] = {"median_ms": med, "steps": timed, "profiled": profiled,
                "train_phase_step_ms": ctx["train"]["step_ms"], "launches": launches}
    ctx["mesh_launches"] = launches
    del state, plain, states, steps
    torch.cuda.empty_cache()
    return out


def _profiled_step(torch, step) -> dict:
    """One train step under torch.profiler: its wall ms (the profiler's own
    cost included), the device's busy ms (the sum of the device events'
    times), device events run, and the five host ops of most self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rec = step()
    events = prof.key_averages()
    # the device's own events (kernels, copies, fills); a host op's device
    # total would count its kernels a second time
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:5]
    res = {"wall_ms": rec["ms"], "device_busy_ms": sum(e.self_device_time_total
                                                        for e in device) / 1e3,
           "device_ops": sum(e.count for e in device),
           "host_top": [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in top]}
    print(f"mesh (c) profiled: wall {res['wall_ms']:.3f} ms, device busy "
          f"{res['device_busy_ms']:.3f} ms over {res['device_ops']} device ops; host self time "
          + ", ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in res["host_top"]), flush=True)
    return res


def _mesh_ulysses_moe(ctx, mesh):
    """mesh (d) and (e)."""
    import torch

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.ops.attention import attention, reference_attention
    from ray_tpu_torch.parallel.expert import MoeConfig, moe_apply, moe_init, moe_logical_axes
    from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, shard_pytree
    from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    # (d) Ulysses with the port's attention at llama_1b's heads, B8 S2048
    (q, k, v), = _flash_case(torch, *TRAIN_ATTN, seed=90)
    _kernels.reset_counts()
    with torch.no_grad():
        out = ulysses_attention_sharded(q, k, v, mesh, causal=True, axis_name="sp",
                                        attn_fn=attention).full_tensor()
    torch.cuda.synchronize()
    counts = dict(_kernels.launch_counts)
    require_no_plain(counts, "mesh (d)")
    require(counts == {"flash_fwd": 1}, f"mesh (d) launched {counts}, expected one flash_fwd")
    ref = reference_attention(q, k, v, causal=True)
    err = (out.float() - ref.float()).abs().max().item()
    ratio = close_ratio(out, ref)
    print(f"mesh (d) ulysses_attention_sharded {TRAIN_ATTN}, attn_fn attention: max_abs_err "
          f"{err:.3e}, worst error / (atol {KERNEL_ATOL} + rtol {KERNEL_RTOL} |plain|) = "
          f"{ratio:.3f} (must be <= 1), launches {counts}", flush=True)
    require(bool(torch.isfinite(out).all()) and ratio <= 1.0, f"mesh (d) disagrees: {ratio}")
    out_d = {"max_abs_err": err, "ratio": ratio, "launches": counts}
    del q, k, v, out, ref

    # (e) MoE at llama_1b's widths: bf16 against fp32 on the bf16-rounded inputs
    cfg = MoeConfig(num_experts=8, top_k=2)
    params = moe_init(0, cfg, hidden=2048, ffn=8192, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(91)
    x = torch.randn((8, 2048, 2048), generator=g, device="cuda").to(torch.bfloat16)
    axes = moe_logical_axes()
    results = {}
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        p = shard_pytree({n: w.to(torch.float32 if n == "router" else dtype)
                          for n, w in params.items()}, axes, mesh, DEFAULT_LLM_RULES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            y, aux = moe_apply(p, x.to(dtype), cfg, mesh=mesh, rules=DEFAULT_LLM_RULES)
            y = y.full_tensor().float()
        torch.cuda.synchronize()
        results[name] = (y, aux["moe_dropped_fraction"].full_tensor().item(),
                         time.perf_counter() - t0)
        del p
    (yb, dropb, tb), (yf, dropf, tf) = results["bf16"], results["fp32"]
    rel = ((yb - yf).abs().max() / yf.abs().max()).item()
    hidden, ffn = params["w_gate"].shape[1:]
    print(f"mesh (e) moe_apply hidden {hidden} ffn {ffn}, {cfg.num_experts} experts top-{cfg.top_k}, "
          f"{x.shape[0] * x.shape[1]} tokens: bf16 against fp32 max|diff|/max|fp32| {rel:.3e} "
          f"(tol {MOE_RTOL}); dropped fraction bf16 {dropb:.6f} fp32 {dropf:.6f}; "
          f"{tb * 1e3:.1f} ms bf16, {tf * 1e3:.1f} ms fp32 (first calls)", flush=True)
    require(bool(torch.isfinite(yb).all()) and rel <= MOE_RTOL, f"mesh (e) disagrees: {rel}")
    require(dropb == dropf, f"mesh (e): the routing differs: dropped {dropb} against {dropf}")
    del results, yb, yf, params, x
    torch.cuda.empty_cache()
    return {"d": out_d, "e": {"rel": rel, "dropped": dropb}}


def main() -> int:
    if len(sys.argv) > 1:
        print(f"usage: {sys.argv[0]} (takes no arguments)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import ray_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the ray_tpu_torch package is missing: {e}", file=sys.stderr)
        return 2

    ctx = {}
    for name in PHASES:
        t0 = time.perf_counter()
        print(f"== phase {name}", flush=True)
        try:
            globals()[f"phase_{name}"](ctx)
        except Exception as e:  # noqa: BLE001 - report the phase, then fail the run
            import traceback

            traceback.print_exc()
            print(f"chip_smoke: phase {name} FAILED: {e}", file=sys.stderr)
            return 1
        print(f"== phase {name} passed in {time.perf_counter() - t0:.1f} s", flush=True)

    # launches: each kernel's count from the run of the path it lies on
    runs = {"k1": ctx["launches"], "k1l": ctx["train_launches"], "k2": ctx["train_launches"],
            "k3": ctx["train_launches"], "k4": ctx["launches"]}
    kernels = []
    for key, run in runs.items():
        entry = dict(ctx[key], launches=run.get(ctx[key]["name"], 0))
        if key in ("k1l", "k2", "k3"):  # the same kernels in the vit phase's 10 timed steps
            entry["launches_vit"] = ctx["vit_launches"].get(entry["name"], 0)
            # and in the mesh phase's timed steps (sharded and unsharded in turns)
            entry["launches_mesh"] = ctx["mesh_launches"].get(entry["name"], 0)
        kernels.append(entry)
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        print(f"chip_smoke: kernels never launched on the main path: {idle}", file=sys.stderr)
        return 1
    record = {"card": ctx["card"], "smi": ctx["smi"], "build_s": ctx["build_s"],
              "peaks": ctx["peaks_key"], "kernels": kernels,
              "model_rel_err": ctx["model_rel_err"], "serve": ctx["serve"],
              "train": ctx["train"], "rl": ctx["rl"], "vit": ctx["vit"], "mesh": ctx["mesh"]}
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in e.items() if not k.startswith("shape")}
                                  for e in kernels]}))
    print(ctx["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": ctx["card"],
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
