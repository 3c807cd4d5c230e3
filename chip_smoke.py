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
  runtime  the port's in-process runtime (ray_tpu_torch.init) with its GPU
           resource: (a) one GPU in cluster_resources and the accelerator
           ids; (b) a bf16 CUDA tensor through put/get and a num_gpus=1
           task argument, the same tensor (data_ptr); two num_gpus=1 tasks
           one after the other (start and end stamps); an actor with
           num_gpus=1 keeping a CUDA tensor across calls; (c) the train
           phase's llama_1b step (B8 S2048, save_attn, seed 0) inside
           GpuTrainer (one worker, use_gpu), 3 warm-up + 5 timed steps with
           train.report after each, in turns with the same loop run directly
           (direct, trainer, trainer, direct): losses within 1e-6 and
           whether bit-equal, ms a step both ways, exact launches read in
           this thread; (d) restart from checkpoint: llama_1b's width at 2
           layers, B2 S512, FailureConfig(max_failures=1), the TrainState
           torch.saved after step 2, a failure before step 3, the second
           attempt resuming from it; losses against an uninterrupted run's,
           the checkpoint's bytes and its save and load seconds.
  serve_app  llama_1b through the port's Serve control plane
           (ray_tpu_torch.serve), seed-0 weights on the card:
           (a) LLMDeployment(model="llama_1b", num_slots=64, decode_chunk=32)
           called directly: 4 prompts (32, 64, 128, 256 tokens) one at a
           time, 64 new tokens each, then the 64 requests of the serve phase
           submitted together; (b) the same deployment through serve.run
           on a replica with ray_actor_options={"num_gpus": 1} (HTTP on port
           0): the 4 prompts one at a time through the handle, tokens equal
           to (a)'s; (c) the 64 requests together through the handle: every
           one 64 tokens, flash_fwd and paged_attention launched exactly once
           a layer for each prefill program and decode tick, no plain call;
           wall, req/s, TTFT and latency p50/p99 beside (a)'s and the serve
           phase's; (d) one request over HTTP to /llm and one streamed
           through handle.options(stream=True), tokens equal to the
           handle's; (e) serve.shutdown() and ray_tpu_torch.shutdown() leave
           no engine thread alive.
  rl_platform  DQN and IMPALA (ray_tpu_torch.rl) with their learners on the
           card: (a) one make_dqn_update step of DQNConfig() (128x128,
           batch 64 from the prioritized buffer, with its weights) and one
           make_impala_update step of ImpalaConfig() (B8, T32), in fp32 on
           the card and on the CPU from the same parameters and batch: loss
           and parameters within 1e-4 relative; (b) tests/test_rl_platform.py's
           chain runs with the learners on cuda: DQN's episode_return_mean
           > 50 after 18 iterations, IMPALA's > 30 after 30 with mean_rho
           finite and positive; (c) DQNConfig() and ImpalaConfig() on
           CartPole-rt with 2 runners, 5 iterations each: env steps/s,
           updates/s, the time sampling (or waiting for unrolls) against the
           learner's; (d) one of (c)'s DQN runners killed behind the group's
           back: the next sample still returns both shares.
  c5       fault C5's shapes and dtypes: (a) K4 at groups 1, 2, 8, 16 and 32
           (D128) and group 4 at D256, bf16, against its plain version at
           the serving table and a long ragged shape, twice bitwise equal,
           event- and graph-timed beside the plain version; (b) every
           CUDA-core kernel of csrc/attention_simt.cu in fp32 at D64/128/256
           (atol = rtol = 2e-5) and bf16 at D256 against its plain version,
           then timed at the c5 paths' shapes beside SDPA and its bound (fp32
           operations at the CUDA cores' fp32 peak; bf16 at the bf16
           tensor-core peak); (c)
           LLMEngine at llama_1b's width with 2 layers for MHA, group 8 and
           D256 in bf16 and group 4 in fp32, 8 requests each, exact
           launches of each route's kernels, fp32 tokens equal to the plain
           path's; (d) fp32 training (B2 S512) against the plain path: every
           gradient of the first step (relative norm, leaf by leaf), then 3
           train steps at a nonzero learning rate from the first update,
           each loss.
  data     512 seeded 224 px PNGs through read_images, map_batches,
           streaming_split(1) and iter_torch_batches(batch_size=32) into 20
           ViT-L/16 steps (ray_tpu_torch.bench_data_train): images/s, the
           input-starved fraction, the per-op stats; 24 launches each of
           K1', K2, K3 a step; the first 3 losses bit-equal to the same
           batches fed directly; one 2-worker GpuTrainer(datasets=...) run
           on CPU workers counting rows.
  cluster  the port's cluster runtime (ray_tpu_torch.cluster: a GCS, a node
           agent and worker processes) on the card: (a) the head agent
           counts the card itself (GPU equal to torch.cuda.device_count()),
           the native shm arena is live; GCS, agent and first-worker
           seconds; (b) a num_gpus=1 task sees CUDA_VISIBLE_DEVICES=0 and
           computes on cuda, a CPU task sees no card, neither process holds
           the JAX package; a 256 MB bf16 CUDA tensor put by the driver is
           read on the card by a GPU task, put again and read back by the
           driver bit-equal, GB/s each way; (c) a SPREAD num_gpus=1 task
           placed by a line-JSON external policy server (its own small
           cluster); (d) serve_app's LLMDeployment (llama_1b, seed-0
           weights drawn in the replica) through serve.run on a replica
           that is a worker process: serve_app's 4 prompts give (a)'s
           tokens, its 64 requests with the replica's own launch counts
           exact against its prefill programs and decode ticks, req/s, TTFT
           and latency beside serve_app's; (e) the runtime phase's llama_1b
           loop (B8 S2048, 3 + 5 steps) in GpuTrainer whose TrainWorker is a
           worker process: losses bit-equal to the runtime phase's direct
           run, K1', K2, K3 22 launches each a step (counted in that
           process, reported through train.report), ms a step beside
           direct; each process's peak max_memory_allocated.
  cluster_apps  Serve's RPC ingress and a compiled DAG on a port Cluster of
           two nodes (the head: 8 CPUs and the card; a CPU-only node whose
           agent sees no card): (a) ray_tpu_torch.util.state lists both,
           GPU 1 on the head only, cluster_summary agreeing; (b)
           serve.start(proxy_location="every_node", http_port=0), then
           serve_app's LLMDeployment (llama_1b, seed-0 weights drawn in the
           replica, num_slots=64, decode_chunk=32) on a num_gpus=1 replica:
           serve_app's 4 prompts through HTTP on each node's proxy and
           through the CPU node's ServeRpcClient, unary and streamed item by
           item, all giving serve_app (a)'s tokens; the 64 requests at once
           through that RPC ingress (req/s, TTFT, latency beside the cluster
           phase's (d)), the replica's K1 and K4 launches exact against its
           prefill programs and decode ticks, plain 0; serve.shutdown()
           gives the card's memory back; (c) `with InputNode() as step:
           learner.step.bind(maker.make.bind(step))` compiled: a CPU maker
           on the head (the runtime phase's B8 S2048 batch from seed 0, as
           numpy) feeding a num_gpus=1 learner (one step of the runtime
           phase's llama_1b loop a call) over native shared-memory
           channels; 3 + 5 execute(i): losses bit-equal to the runtime
           phase's direct run, K1', K2, K3 22 launches each a step in the
           learner's process, a bf16 CUDA slice of a parameter through the
           output channel landing on cuda bit-equal to the learner's own
           after teardown() (a normal actor call); (d) the transfer probe
           (ray_tpu_torch.bench.measure_object_transfer: 16 MB pulled by a
           second agent, raw_transfer true, MB/s).
  ops_shell  the operator's entry points, under a temp HOME: (a) `python -m
           ray_tpu_torch start --head --num-cpus 4` under
           CUDA_VISIBLE_DEVICES="" (the head takes no card), `status` shows
           1 node and no GPU; (b) a StandardAutoscaler over LocalNodeProvider
           in this process, worker nodes of 2 CPUs and 1 GPU, at most 1,
           idle timeout 10 s; (c) `python -m ray_tpu_torch submit
           --working-dir <repo> -- python llama_job.py`, its log streamed by
           the CLI: the job's driver (ray_tpu_torch.init() from
           RAY_TPU_ADDRESS) creates one num_gpus=1 actor, pending until the
           autoscaler's node is up (120 s, else the job fails), which in
           that node's GPU worker (1) serves the serve phase's first 4
           prompts one at a time through LLMEngine at the serve phase's
           settings (llama_1b, seed-0 weights): tokens equal to the serve
           phase's, K1 and K4 exact against its prefill programs and decode
           ticks, plain 0; (2) runs 3 llama_1b steps (B8 S2048, seed 0):
           losses bit-equal to the runtime phase's direct run, K1', K2, K3
           22 launches each a step; (3) carries the trained parameters and
           AdamW moments through params_to_jax and params_from_jax, every
           leaf's bits equal (without ml_dtypes: params_to_jax's ImportError
           naming it); (d) the job SUCCEEDED, `list jobs` shows return code
           0, `logs` holds its JSON line; seconds from submit to the node
           alive, to the first result, to the job's end; (e) the idle node
           terminated within 30 s of the job's end, the card's free memory
           back within 1 GiB in 10 s, `stop` leaves no process of the
           session and no new /dev/shm/rtpt-* file.

Every launch check also requires attention_plain == paged_attention_plain
== 0: the dispatch rule sends no llama_1b or ViT-L call to a plain version,
and under the mesh the attention reaches the kernels through local_map.

Prints {"kernels": [...]} and the nvidia-smi line before the last line; the
last line is {"ok": true, "device": {...}} only when every phase passed. Any
failure exits non-zero and prints no result. Each kernel's launches come
from the phase whose path runs it (serve: flash_fwd, paged_attention; train:
flash_fwd_lse, flash_bwd_dq, flash_bwd_dkv; the latter three also carry
launches_vit, launches_mesh, launches_runtime, launches_data,
launches_cluster and launches_cluster_apps, from the vit and mesh phases'
timed steps, the runtime phase's first GpuTrainer run, the data phase's
steps, the cluster phase's TrainWorker process and the cluster_apps
phase's compiled-DAG learner; the first two also carry launches_serve_app,
from the serve_app phase's 64 requests, launches_c5, from the c5 phase's
bf16 engines, launches_cluster, from the cluster phase's replica process,
and launches_cluster_apps, from the cluster_apps phase's replica behind the
RPC ingress; all five carry launches_ops_shell, from the ops_shell phase's
actor on the autoscaled node: its 4 prompts for the first two, its 3 train
steps for the other three; the CUDA-core kernels' launches come from the c5
phase's fp32 and D256 engines and its fp32 train steps). paged_attention's
entry also carries the c5 phase's widened shapes, its keys suffixed
_g<group>_d<head dim>. A copy of the results goes to build/chip_smoke.json.
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

PHASES = ("device", "kernels", "model", "serve", "train", "rl", "vit", "mesh", "runtime",
          "serve_app", "rl_platform", "c5", "data", "cluster", "cluster_apps", "ops_shell")

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
    device's time, without the host's cost of each launch. The capture is
    thread-local: a thread an earlier phase left running (an env runner
    finishing its rollout) may call CUDA meanwhile without invalidating it."""
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
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
    for name in ("flash_fwd", "flash_bwd", "paged_attention", "attention_simt"):
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
        return _paged_inputs(torch, seed, B, lo, hi, total_pages, trash_slots, nh, nkv, D)

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


def _paged_inputs(torch, seed, B, lo, hi, total_pages, trash_slots, nh, nkv, D, ps=64,
                  max_pages=32, dtype=None):
    """Inputs of paged_attention on the card: B slots of lo..hi rows, each on
    its own random pages of a pool of ``total_pages`` (page 0 the trash
    page); the first ``trash_slots`` slots hold 1 row and an all-zero table
    row, as inactive slots do. q is pre-scaled."""
    dtype = dtype or torch.bfloat16
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
    kp = torch.randn((nkv, total_pages, ps, D), generator=gd, device="cuda").to(dtype)
    vp = torch.randn((nkv, total_pages, ps, D), generator=gd, device="cuda").to(dtype)
    q = (torch.randn((B, nh, D), generator=gd, device="cuda") * D ** -0.5).to(dtype)
    return q, kp, vp, table.cuda(), lengths.cuda()


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


# the serve phase's engine (the ops_shell phase's GPU actor builds the same)
SERVE_ENGINE_KW = dict(paged=True, num_slots=64, page_size=64, total_pages=513,
                       decode_chunk=32, prefill_buckets=[64, 256, 512])


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
    engine = LLMEngine(cfg, params, device="cuda", **SERVE_ENGINE_KW)
    try:
        # warm-up request (cuBLAS handles, allocator), then the first 4 prompts
        # (one of each length) one at a time: the ops_shell phase's reference
        engine.generate(prompts[0], max_tokens=4, timeout=600)
        singles = [engine.generate(p, max_tokens, None, 600)["tokens"] for p in prompts[:4]]
        ctx["serve_singles"] = {"prompts": prompts[:4], "tokens": singles}
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


# The runtime phase's llama_1b loop: the train phase's configuration
# (ray_tpu_torch.bench.train_bench's), 3 warm-up then 5 timed steps.
RUNTIME_WARMUP, RUNTIME_STEPS = 3, 5
# Trainer against direct losses (c), and resumed against uninterrupted (d):
# the same kernels on the same tensors from the same seed, so only a change
# of arithmetic could move them; bf16 rounding of one element moves a mean
# over 16384 or 1024 tokens by far more than this.
RUNTIME_LOSS_RTOL = 1e-6
# (d): llama_1b's width and heads at 2 layers, B2 S512; the TrainState saved
# after step 2, a failure before step 3 of the first attempt, steps 3..5 from
# the checkpoint.
RESTART_LAYERS, RESTART_SAVE_AT, RESTART_STEPS = 2, 2, 6


def _runtime_llama_loop(report, steps=None, layers=None):
    """llama_1b, save_attn, B8 S2048 from seed 0 (train_bench's data and
    optimizer): ``steps`` steps (RUNTIME_WARMUP + RUNTIME_STEPS unless
    given; ``layers``: llama_1b's width at fewer layers), ``report(metrics)``
    after each with the step's ms (step and loss read), a host clock stamp
    and the kernels it launched. Returns the TrainState after the last."""
    import dataclasses

    import numpy as np
    import torch

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train.step import (default_optimizer, make_train_state_factory,
                                          make_train_step)

    cfg = LlamaConfig.llama_1b(max_seq_len=2048, remat="save_attn", attention_impl="flash")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    opt = default_optimizer(warmup_steps=10, total_steps=1000)
    state = make_train_state_factory(cfg, opt)(seed=0, device="cuda")
    step = make_train_step(cfg, opt)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 2048))).cuda()
    targets = torch.roll(tokens, -1, dims=1)
    torch.cuda.synchronize()
    for i in range(steps or RUNTIME_WARMUP + RUNTIME_STEPS):
        before = dict(_kernels.launch_counts)
        t0 = time.perf_counter()
        state, metrics = step(state, tokens, targets)
        loss = metrics["loss"].item()  # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        report({"step": i, "loss": loss, "ms": ms, "t": time.perf_counter(),
                "launches": {n: c - before.get(n, 0) for n, c in _kernels.launch_counts.items()
                             if c != before.get(n, 0)}})
    return state


def _runtime_restart_loop(crash: bool):
    """(d)'s train function: llama_1b's width at RESTART_LAYERS layers, B2
    S512. After step RESTART_SAVE_AT it torch.saves its TrainState and reports
    it as a checkpoint; with ``crash`` the first attempt raises before the
    next step; an attempt that finds a checkpoint resumes from it."""
    def train_fn(config):
        import dataclasses
        import tempfile

        import numpy as np
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models.llama import LlamaConfig
        from ray_tpu_torch.train.step import (default_optimizer, make_train_state_factory,
                                              make_train_step)

        cfg = dataclasses.replace(LlamaConfig.llama_1b(max_seq_len=512, remat="save_attn",
                                                       attention_impl="flash"),
                                  num_layers=RESTART_LAYERS)
        opt = default_optimizer(warmup_steps=10, total_steps=1000)
        step = make_train_step(cfg, opt)
        rng = np.random.default_rng(1)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512))).cuda()
        targets = torch.roll(tokens, -1, dims=1)
        ckpt = train.get_checkpoint()
        load_s = None
        if ckpt is None:
            state = make_train_state_factory(cfg, opt)(seed=0, device="cuda")
        else:
            t0 = time.perf_counter()
            state = torch.load(os.path.join(ckpt.path, "state.pt"), weights_only=False)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        for i in range(state.step, RESTART_STEPS):
            if crash and ckpt is None and i == RESTART_SAVE_AT + 1:
                raise RuntimeError(f"simulated failure before step {i}")
            state, metrics = step(state, tokens, targets)
            rec = {"step": i, "loss": metrics["loss"].item(), "load_s": load_s}
            if i != RESTART_SAVE_AT:
                train.report(rec)
                continue
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "state.pt")
                t0 = time.perf_counter()
                torch.save(state, path)
                rec.update(save_s=time.perf_counter() - t0, bytes=os.path.getsize(path))
                train.report(rec, checkpoint=train.Checkpoint.from_directory(d))
    return train_fn


def phase_runtime(ctx):
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt

    torch.cuda.empty_cache()
    if rt.is_initialized():
        rt.shutdown()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    rt.init(num_cpus=8)
    try:
        # (a) the GPU resource
        res = rt.cluster_resources()
        ids = rt.get_runtime_context().get_accelerator_ids()
        print(f"runtime (a): cluster_resources GPU {res.get('GPU')}, CPU {res.get('CPU')}; "
              f"accelerator ids {ids}", flush=True)
        require(res.get("GPU") == 1 and ids == {"GPU": ["0"]},
                f"runtime (a): expected one GPU, got {res.get('GPU')} and {ids}")
        out = {"a": {"GPU": res["GPU"], "accelerator_ids": ids}}
        out["b"] = _runtime_objects(rt, torch)
        out["c"] = _runtime_trainer(ctx, rt, torch, tmp)
        out["d"] = _runtime_restart(rt, tmp)
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    require(not os.path.exists(tmp), f"runtime: {tmp} was not removed")
    ctx["runtime"] = out
    torch.cuda.empty_cache()


def _runtime_objects(rt, torch):
    """runtime (b): CUDA tensors through put/get, task arguments and an
    actor, zero-copy; two num_gpus=1 tasks one after the other."""
    x = torch.randn((4096, 4096), device="cuda").to(torch.bfloat16)
    got = rt.get(rt.put(x))
    require(got is x and got.data_ptr() == x.data_ptr(), "runtime (b): put/get copied the tensor")

    @rt.remote(num_gpus=1)
    def where(t):
        return t.data_ptr(), str(t.device), t.dtype

    ptr, dev, dtype = rt.get(where.remote(x))
    ptr_ref = rt.get(where.remote(rt.put(x)))[0]
    require(ptr == ptr_ref == x.data_ptr() and dev == "cuda:0" and dtype == torch.bfloat16,
            f"runtime (b): the task saw {ptr:#x} {dev} {dtype}, put {x.data_ptr():#x}")

    @rt.remote(num_gpus=1)
    def busy(t):
        start = time.perf_counter()
        for _ in range(50):
            y = t @ t
        value = y.float().abs().mean().item()  # waits for the products
        return start, time.perf_counter(), value

    t0 = time.perf_counter()
    stamps = sorted(r[:2] for r in rt.get([busy.remote(x), busy.remote(x)]))
    rel = [(round((a - t0) * 1e3, 3), round((b - t0) * 1e3, 3)) for a, b in stamps]
    print(f"runtime (b): two num_gpus=1 tasks, (start, end) ms after submission: {rel}",
          flush=True)
    require(stamps[0][1] <= stamps[1][0], f"runtime (b): num_gpus=1 tasks overlapped: {rel}")

    class Holder:
        def __init__(self):
            self.t = torch.zeros((1024, 1024), device="cuda", dtype=torch.bfloat16)

        def bump(self):
            self.t.add_(1)
            return self.t.data_ptr(), str(self.t.device), self.t[0, 0].item()

    h = rt.remote(Holder).options(num_gpus=1).remote()
    calls = [rt.get(h.bump.remote()) for _ in range(3)]
    held = rt.available_resources().get("GPU", 0)
    rt.kill(h)
    deadline = time.monotonic() + 10
    while rt.available_resources().get("GPU", 0) < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    print(f"runtime (b): actor with num_gpus=1, 3 calls (data_ptr, device, value): {calls}; "
          f"GPU available while it lived {held}, after kill "
          f"{rt.available_resources().get('GPU', 0)}", flush=True)
    require(len({c[0] for c in calls}) == 1 and [c[2] for c in calls] == [1.0, 2.0, 3.0]
            and calls[0][1] == "cuda:0", f"runtime (b): the actor's tensor moved: {calls}")
    require(held == 0 and rt.available_resources().get("GPU") == 1,
            "runtime (b): the actor's GPU was not held or not released")
    return {"task_stamps_ms": rel, "actor_calls": [list(c) for c in calls]}


def _runtime_trainer(ctx, rt, torch, tmp):
    """runtime (c): the llama_1b loop inside GpuTrainer (one worker,
    use_gpu) and directly in this thread, in turns: direct, trainer,
    trainer, direct."""
    import gc

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.train import GpuTrainer, RunConfig, ScalingConfig

    L = _llama_1b().num_layers
    want = {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    n = RUNTIME_WARMUP + RUNTIME_STEPS

    def direct():
        history = []
        _runtime_llama_loop(history.append)
        return history

    def trainer(i):
        def train_fn(config):
            from ray_tpu_torch import train

            _runtime_llama_loop(train.report)

        r = GpuTrainer(train_fn, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                       run_config=RunConfig(name=f"llama_1b_{i}", storage_path=tmp)).fit()
        require(r.error is None, f"runtime (c): the trainer failed: {r.error!r}")
        return r.metrics_history

    runs = []
    for i, which in enumerate(("direct", "trainer", "trainer", "direct")):
        gc.collect()  # the last run's state must be gone before the next allocates its own
        torch.cuda.empty_cache()
        _kernels.reset_counts()
        history = direct() if which == "direct" else trainer(i)
        counts = dict(_kernels.launch_counts)
        require(len(history) == n, f"runtime (c) {which}: {len(history)} reports, expected {n}")
        for rec in history:
            require(math.isfinite(rec["loss"]), f"runtime (c) {which}: non-finite loss {rec}")
            require(rec["launches"] == want, f"runtime (c) {which} step {rec['step']} launched "
                    f"{rec['launches']}, expected {want} and no other kernel")
        # the counts read here include every launch made on the trainer's thread
        require(counts == {k: v * n for k, v in want.items()},
                f"runtime (c) {which}: this thread read {counts}, expected {n} x {want}")
        require_no_plain(counts, f"runtime (c) {which}")
        timed = history[RUNTIME_WARMUP:]
        period = [(b["t"] - a["t"]) * 1e3 for a, b in zip(history[RUNTIME_WARMUP - 1:], timed)]
        runs.append({"which": which, "losses": [r["loss"] for r in history],
                     "ms": [r["ms"] for r in timed], "period_ms": period,
                     "median_ms": statistics.median(r["ms"] for r in timed),
                     "median_period_ms": statistics.median(period), "launches": counts})
        if which == "trainer":
            print(f"runtime (c) GpuTrainer metrics_history: "
                  f"{[{k: r[k] for k in ('step', 'loss', 'ms')} for r in history]}", flush=True)
        print(f"runtime (c) {which}: median {runs[-1]['median_ms']:.3f} ms a step "
              f"(step and loss read), median {runs[-1]['median_period_ms']:.3f} ms from one "
              f"step's report to the next; launches {counts}", flush=True)
    ref = runs[0]["losses"]
    worst = max(abs(a - b) / abs(b) for r in runs[1:] for a, b in zip(r["losses"], ref))
    bit_equal = all(r["losses"] == ref for r in runs)
    med = {w: statistics.median(x for r in runs if r["which"] == w for x in r["period_ms"])
           for w in ("direct", "trainer")}
    step_med = {w: statistics.median(x for r in runs if r["which"] == w for x in r["ms"])
                for w in ("direct", "trainer")}
    print(f"runtime (c) on {ctx['card']} ({ctx['smi']}): llama_1b, {L} layers, save_attn, B8 "
          f"S2048, {RUNTIME_WARMUP} + {RUNTIME_STEPS} steps a run, in turns direct, trainer, "
          f"trainer, direct: losses bit-equal {bit_equal}, max relative difference {worst:.3e} "
          f"(tol {RUNTIME_LOSS_RTOL}); median ms a step (step and loss read) direct "
          f"{step_med['direct']:.3f}, trainer {step_med['trainer']:.3f}; report to report "
          f"direct {med['direct']:.3f}, trainer {med['trainer']:.3f} (the runtime's thread, "
          f"session and lockstep report: {med['trainer'] - med['direct']:.3f} ms a step)",
          flush=True)
    require(worst <= RUNTIME_LOSS_RTOL, f"runtime (c): trainer losses differ by {worst}")
    ctx["runtime_launches"] = runs[1]["launches"]
    # the cluster phase's trainer is held against the first direct run
    ctx["runtime_direct"] = {"losses": runs[0]["losses"], "median_ms": step_med["direct"],
                             "median_trainer_ms": step_med["trainer"]}
    return {"runs": runs, "bit_equal": bit_equal, "max_rel_loss": worst,
            "median_period_ms": med, "median_step_ms": step_med}


def _runtime_restart(rt, tmp):
    """runtime (d): FailureConfig(max_failures=1) restarts from the
    torch.saved TrainState; the losses match an uninterrupted run's."""
    from ray_tpu_torch.train import FailureConfig, GpuTrainer, RunConfig, ScalingConfig

    results = {}
    for name, crash in (("uninterrupted", False), ("restarted", True)):
        t0 = time.perf_counter()
        r = GpuTrainer(_runtime_restart_loop(crash),
                       scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                       run_config=RunConfig(name=f"restart_{name}", storage_path=tmp,
                                            failure_config=FailureConfig(max_failures=1))).fit()
        require(r.error is None, f"runtime (d) {name}: {r.error!r}")
        results[name] = (r.metrics_history, time.perf_counter() - t0)
    whole, restarted = results["uninterrupted"][0], results["restarted"][0]
    require([m["step"] for m in restarted] == list(range(RESTART_STEPS)),
            f"runtime (d): the restarted run reported steps {[m['step'] for m in restarted]}")
    tail = slice(RESTART_SAVE_AT + 1, RESTART_STEPS)
    a, b = [m["loss"] for m in restarted[tail]], [m["loss"] for m in whole[tail]]
    worst = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    saved = restarted[RESTART_SAVE_AT]
    load_s = restarted[RESTART_SAVE_AT + 1]["load_s"]
    print(f"runtime (d): llama_1b width, {RESTART_LAYERS} layers, B2 S512; checkpoint after step "
          f"{RESTART_SAVE_AT}: {saved['bytes']} bytes, torch.save {saved['save_s']:.3f} s, "
          f"torch.load {load_s:.3f} s; losses from step {RESTART_SAVE_AT + 1} restarted {a}, "
          f"uninterrupted {b}: bit-equal {a == b}, max relative difference {worst:.3e} (tol "
          f"{RUNTIME_LOSS_RTOL}); fits {results['uninterrupted'][1]:.3f} s and "
          f"{results['restarted'][1]:.3f} s", flush=True)
    require(load_s is not None, "runtime (d): the second attempt did not load the checkpoint")
    require(worst <= RUNTIME_LOSS_RTOL, f"runtime (d): resumed losses differ by {worst}")
    return {"losses_restarted": a, "losses_uninterrupted": b, "bit_equal": a == b,
            "max_rel_loss": worst, "bytes": saved["bytes"], "save_s": saved["save_s"],
            "load_s": load_s}



# --------------------------------------------------------------------------- #
# serve_app: llama_1b through the port's Serve control plane
# --------------------------------------------------------------------------- #
SERVE_APP_REQUESTS, SERVE_APP_TOKENS = 64, 64
# LLMDeployment's arguments in both (a) and (b): the serve phase's slots and
# chunk; the rest are LLMDeployment's (and LLMEngine's) defaults
SERVE_APP_KW = dict(model="llama_1b", num_slots=64, decode_chunk=32)


def _pct(values, q):
    """The q-th percentile by nearest rank."""
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def _load_figures(results, ends, t0):
    wall = max(ends) - t0
    ttft = [r["ttft_s"] for r in results]
    lat = [e - t0 for e in ends]
    return {"requests": len(results), "wall_s": wall, "req_per_s": len(results) / wall,
            "tok_per_s": sum(len(r["tokens"]) for r in results) / wall,
            "p50_ttft_s": _pct(ttft, 50), "p99_ttft_s": _pct(ttft, 99),
            "p50_latency_s": _pct(lat, 50), "p99_latency_s": _pct(lat, 99)}


def _fmt_load(f):
    return (f"{f['requests']} requests in {f['wall_s']:.3f} s: {f['req_per_s']:.3f} req/s, "
            f"{f['tok_per_s']:.1f} tok/s, TTFT p50 {f['p50_ttft_s'] * 1e3:.1f} ms p99 "
            f"{f['p99_ttft_s'] * 1e3:.1f} ms, latency from submission p50 "
            f"{f['p50_latency_s'] * 1e3:.1f} ms p99 {f['p99_latency_s'] * 1e3:.1f} ms")


def _run_load(call, prompts, max_tokens):
    """All requests submitted together, each resolved on its own thread: the
    results, the time each one was back, and the start."""
    def one(p):
        out = call({"tokens": p, "max_tokens": max_tokens, "timeout": 600})
        return out, time.perf_counter()

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(prompts)) as pool:
        done = list(pool.map(one, prompts))
    return [d[0] for d in done], [d[1] for d in done], t0


def _threads(name):
    import threading

    return [t for t in threading.enumerate() if t.name == name and t.is_alive()]


def _until_gone(name, timeout):
    deadline = time.monotonic() + timeout
    while _threads(name) and time.monotonic() < deadline:
        time.sleep(0.1)
    return not _threads(name)


def phase_serve_app(ctx):
    import gc
    import urllib.request

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch import _kernels, serve
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init
    from ray_tpu_torch.serve.llm import LLMDeployment

    gc.collect()
    torch.cuda.empty_cache()
    if rt.is_initialized():
        rt.shutdown()
    cfg = LlamaConfig.llama_1b()  # what LLMDeployment(model="llama_1b") builds
    L = cfg.num_layers
    params = llama_init(cfg, seed=0, device="cuda")
    kw = dict(SERVE_APP_KW, params=params)
    n_req, max_tokens = SERVE_APP_REQUESTS, SERVE_APP_TOKENS
    rng = torch.Generator().manual_seed(7)
    lens = [(32, 64, 128, 256)[i % 4] for i in range(n_req)]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist() for n in lens]
    singles = prompts[:4]  # one of each length
    out = {}
    rt.init(num_cpus=8)
    try:
        # (a) the reference result: the deployment class called directly
        direct = LLMDeployment(**kw)
        try:
            direct.generate({"tokens": singles[0], "max_tokens": 4, "timeout": 600})  # warm-up
            want = [direct.generate({"tokens": p, "max_tokens": max_tokens,
                                     "timeout": 600})["tokens"] for p in singles]
            _kernels.reset_counts()
            res, ends, t0 = _run_load(direct.generate, prompts, max_tokens)
            out["direct"] = _load_figures(res, ends, t0)
            require_no_plain(_kernels.launch_counts, "serve_app (a)")
        finally:
            direct.stop()
        require(not direct.engine._thread.is_alive(),
                "serve_app (a): the direct engine's thread did not stop")
        del direct
        gc.collect()
        torch.cuda.empty_cache()
        print(f"serve_app (a) LLMDeployment called directly: {_fmt_load(out['direct'])}",
              flush=True)

        # (b) deploy on a GPU replica; the same prompts one at a time
        t0 = time.perf_counter()
        app = (serve.deployment(LLMDeployment, name="llm")
               .options(ray_actor_options={"num_gpus": 1}, max_ongoing_requests=n_req)
               .bind(**kw))
        handle = serve.run(app, http=True, http_port=0)
        out["deploy_s"] = time.perf_counter() - t0
        got = [handle.generate.remote({"tokens": p, "max_tokens": max_tokens, "timeout": 600})
               .result(timeout=600)["tokens"] for p in singles]
        print(f"serve_app (b) serve.run with ray_actor_options={{'num_gpus': 1}}: ready in "
              f"{out['deploy_s']:.3f} s; {len(singles)} prompts of {[len(p) for p in singles]} "
              f"tokens one at a time: tokens equal to (a)'s {got == want}", flush=True)
        require(got == want, "serve_app (b): tokens through serve differ from the direct "
                f"deployment's: {[g[:8] for g in got]} against {[w[:8] for w in want]}")

        # (c) the 64 requests submitted together through the handle
        s0 = handle.engine_stats.remote().result(timeout=60)
        _kernels.reset_counts()
        results, ends, t0 = _run_load(
            lambda r: handle.generate.remote(r).result(timeout=600), prompts, max_tokens)
        counts = dict(_kernels.launch_counts)
        s1 = handle.engine_stats.remote().result(timeout=60)
        out["serve"] = _load_figures(results, ends, t0)
        for r in results:
            require(len(r["tokens"]) == max_tokens,
                    f"serve_app (c): a request returned {len(r['tokens'])} tokens")
        require_no_plain(counts, "serve_app (c)")
        programs = s1["prefill_programs"] - s0["prefill_programs"]
        ticks = s1["decode_steps"] - s0["decode_steps"]
        require(counts.get("flash_fwd", 0) > 0 and counts.get("paged_attention", 0) > 0,
                f"serve_app (c): the kernels were not launched: {counts}")
        require(counts.get("flash_fwd") == L * programs
                and counts.get("paged_attention") == L * ticks,
                f"serve_app (c): launches {counts} against {programs} prefill programs and "
                f"{ticks} decode ticks of {L} layers")
        launches = {n: counts.get(n, 0) for n in ("flash_fwd", "paged_attention")}
        out.update(launches=launches, prefill_programs=programs, decode_ticks=ticks)
        ctx["serve_app_launches"] = launches
        direct_fig, serve_phase = out["direct"], ctx["serve"]
        print(f"serve_app (c) on {ctx['card']} ({ctx['smi']}): through serve: "
              f"{_fmt_load(out['serve'])}; launches {launches} ({programs} prefill programs, "
              f"{ticks} decode ticks), plain 0", flush=True)
        print(f"serve_app (c) beside: the same deployment called directly (a) "
              f"{direct_fig['req_per_s']:.3f} req/s, TTFT p50 {direct_fig['p50_ttft_s'] * 1e3:.1f} "
              f"ms; the serve phase's LLMEngine (max_seq_len 2048, its own buckets and pool) "
              f"{serve_phase['req_per_s']:.3f} req/s, TTFT p50 "
              f"{serve_phase['p50_ttft_s'] * 1e3:.1f} ms; serve costs "
              f"{out['serve']['wall_s'] - direct_fig['wall_s']:.3f} s of wall over (a)",
              flush=True)

        # (d) HTTP through the proxy, and streaming through the handle
        addr = serve.http_address()
        req = urllib.request.Request(
            f"{addr}/llm", data=json.dumps({"tokens": singles[1], "max_tokens": max_tokens,
                                            "timeout": 600}).encode(),
            headers={"Content-Type": "application/json"})
        via_http = json.loads(urllib.request.urlopen(req, timeout=600).read())["tokens"]
        records = list(handle.options(stream=True).remote(
            {"tokens": singles[2], "max_tokens": max_tokens, "timeout": 600, "stream": True}))
        streamed = [r["token"] for r in records if "token" in r]
        print(f"serve_app (d): HTTP {addr}/llm tokens equal to the handle's {via_http == got[1]}; "
              f"{len(records)} streamed records, tokens equal to the handle's "
              f"{streamed == got[2]}", flush=True)
        require(via_http == got[1], "serve_app (d): HTTP tokens differ from the handle's")
        require(streamed == got[2] and records[-1].get("done") is True,
                "serve_app (d): streamed tokens differ from the handle's")
    finally:
        serve.shutdown()
        # the controller's loop reconciles once more after its shutdown flag
        # (as the JAX package's does): it ends before the runtime goes
        loop_ended = _until_gone("serve-control-loop", 10)
        rt.shutdown()
    # (e) teardown: the replica's engine stopped with serve
    engines_gone = _until_gone("llm-engine", 30)
    require(loop_ended and engines_gone, f"serve_app (e): threads alive: "
            f"{_threads('serve-control-loop') + _threads('llm-engine')}")
    print("serve_app (e): serve.shutdown() and ray_tpu_torch.shutdown(): no engine thread and "
          "no control loop alive", flush=True)
    ctx["serve_app"] = out
    # the cluster phase sends the same prompts and expects (a)'s tokens
    ctx["serve_app_prompts"] = {"prompts": prompts, "singles": singles, "want": want}
    del params
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# rl_platform: DQN and IMPALA learners on the card
# --------------------------------------------------------------------------- #
# one update, card against CPU in fp32 from the same parameters and batch:
# |card - cpu| / |cpu| for the loss, max |card - cpu| / max |cpu| for each
# parameter after the step
RL_UPDATE_RTOL = 1e-4
# tests/test_rl_platform.py's configurations and thresholds
RL_CHAIN = {"n": 6, "max_steps": 20}
RL_FULL_ITERS = 5


def _rl_rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _rl_update_check(torch, name, make_update, params_cpu, extra, batch, lr):
    """One update on the CPU and on the card from the same parameters and
    batch: (loss rel err, worst parameter rel err)."""
    from ray_tpu_torch.rl.dqn import as_tree, params_to
    from ray_tpu_torch.train.step import _leaves, adamw

    outs = {}
    for dev in ("cpu", "cuda"):
        p = params_to(params_cpu, dev, copy=True)
        args = [params_to(e, dev, copy=True) for e in extra]
        opt = adamw(lr)
        state = opt.init(as_tree(p))
        res = make_update(opt)(p, *args, state, batch)
        outs[dev] = (res[-2].item(), [t.cpu() for t in _leaves(as_tree(p))])
    loss_err = abs(outs["cuda"][0] - outs["cpu"][0]) / abs(outs["cpu"][0])
    param_err = max(_rl_rel(a, b) for a, b in zip(outs["cuda"][1], outs["cpu"][1]))
    print(f"rl_platform (a) {name}: loss card {outs['cuda'][0]:.8f} cpu {outs['cpu'][0]:.8f}, "
          f"relative error {loss_err:.3e}; parameters after the step, worst max|diff|/max|cpu| "
          f"{param_err:.3e} (tol {RL_UPDATE_RTOL})", flush=True)
    require(loss_err <= RL_UPDATE_RTOL and param_err <= RL_UPDATE_RTOL,
            f"rl_platform (a) {name}: the card's update differs from the CPU's")
    return {"loss_rel_err": loss_err, "param_rel_err": param_err}


def _rl_updates(torch):
    """rl_platform (a): DQNConfig() (hidden 128x128, batch 64 from the
    prioritized buffer, with its weights) and ImpalaConfig() (B8, T32)."""
    import numpy as np

    from ray_tpu_torch.rl import dqn, impala
    from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer

    print(f"rl_platform (a): fp32 matmuls on the card allow TF32: "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    require(not torch.backends.cuda.matmul.allow_tf32, "rl_platform (a): TF32 is on")
    rng = np.random.default_rng(0)
    dcfg, n = dqn.DQNConfig(), 2048
    buf = PrioritizedReplayBuffer(dcfg.buffer_capacity, seed=0)
    buf.add_batch({"obs": rng.standard_normal((n, 4)).astype(np.float32),
                   "actions": rng.integers(0, 2, n), "rewards": np.ones(n, np.float32),
                   "next_obs": rng.standard_normal((n, 4)).astype(np.float32),
                   "dones": (rng.random(n) < 0.05).astype(np.float32)})
    buf.update_priorities(np.arange(n), rng.standard_normal(n))
    batch = {k: v for k, v in buf.sample(dcfg.batch_size).items() if k != "indices"}
    out = {"dqn": _rl_update_check(
        torch, "DQN", lambda opt: dqn.make_dqn_update(dcfg, opt),
        dqn.q_init(4, 2, dcfg.hidden, seed=0, device="cpu"),
        [dqn.q_init(4, 2, dcfg.hidden, seed=1, device="cpu")], batch, dcfg.lr)}
    icfg = impala.ImpalaConfig()
    B, T = icfg.batch_unrolls, icfg.unroll_len
    ibatch = {"obs": rng.standard_normal((B, T, 4)).astype(np.float32),
              "next_obs_last": rng.standard_normal((B, 4)).astype(np.float32),
              "actions": rng.integers(0, 2, (B, T)), "rewards": np.ones((B, T), np.float32),
              "dones": (rng.random((B, T)) < 0.05).astype(np.float32),
              "behavior_logits": (rng.standard_normal((B, T, 2)) * 0.5).astype(np.float32)}
    out["impala"] = _rl_update_check(
        torch, "IMPALA", lambda opt: impala.make_impala_update(icfg, opt),
        impala.ac_init(4, 2, icfg.hidden, seed=0, device="cpu"), [], ibatch, icfg.lr)
    return out


def _rl_run(trainer, iters, owner, name):
    """``iters`` train() calls; the time spent in ``owner.name`` (the
    runners' sampling, or the wait for unrolls) against the rest (the
    learner: buffer, updates, the params' publication)."""
    waits = []
    inner = getattr(owner, name)

    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            waits.append(time.perf_counter() - t)

    setattr(owner, name, timed)
    results = []
    t0 = time.perf_counter()
    for _ in range(iters):
        results.append(trainer.train())
    wall = time.perf_counter() - t0
    setattr(owner, name, inner)
    sample_s = sum(waits)
    return results, {"iters": iters, "wall_s": wall, "s_per_iter": wall / iters,
                     "sample_s": sample_s, "learner_s": wall - sample_s}


def _rl_dqn(rt, cfg, iters, label):
    from ray_tpu_torch.rl import DQNTrainer

    trainer = DQNTrainer(cfg)  # no device: the card
    try:
        require(trainer.params[0]["w"].device.type == "cuda",
                f"rl_platform {label}: DQN's parameters are on {trainer.params[0]['w'].device}")
        results, f = _rl_run(trainer, iters, trainer.runners, "sample")
        steps = sum(r["env_steps_this_iter"] for r in results)
        updates = sum(cfg.updates_per_iter for r in results if r["loss"] is not None)
        f.update(env_steps=steps, env_steps_per_s=steps / f["wall_s"], updates=updates,
                 updates_per_s=updates / f["wall_s"],
                 updates_per_learner_s=updates / f["learner_s"] if updates else 0.0,
                 episode_return_mean=results[-1]["episode_return_mean"],
                 loss=results[-1]["loss"])
        print(f"rl_platform {label} DQN on {trainer.device}: {iters} iterations in "
              f"{f['wall_s']:.3f} s ({f['s_per_iter'] * 1e3:.1f} ms each), {steps} env steps "
              f"({f['env_steps_per_s']:.0f}/s), {updates} updates ({f['updates_per_s']:.1f}/s of "
              f"wall, {f['updates_per_learner_s']:.1f}/s of learner time); sampling "
              f"{f['sample_s']:.3f} s, learner {f['learner_s']:.3f} s; episode_return_mean "
              f"{f['episode_return_mean']}, loss {f['loss']}", flush=True)
        if label == "(c)":
            # (d) one runner killed behind the group's back
            from ray_tpu_torch.rl.dqn import params_to

            ref = rt.put(params_to(trainer.params, "cpu", copy=True))
            rt.kill(trainer.runners._runners[0])
            batches = trainer.runners.sample(ref, 16, explore=1.0)
            shares = sorted(b["worker_index"] for b in batches)
            print(f"rl_platform (d): runner 0 killed; the next sample returned shares of "
                  f"workers {shares}, {[len(b['obs']) for b in batches]} steps each", flush=True)
            require(shares == [0, 1] and all(len(b["obs"]) == 16 for b in batches),
                    f"rl_platform (d): sample after a kill returned {shares}")
            f["fault_tolerance_shares"] = shares
    finally:
        trainer.stop()
    return f


def _rl_impala(cfg, iters, label, unrolls):
    import numpy as np

    from ray_tpu_torch.rl import ImpalaTrainer

    trainer = ImpalaTrainer(cfg, total_unrolls_per_runner=unrolls)
    try:
        require(trainer.params["pi"]["w"].device.type == "cuda",
                f"rl_platform {label}: IMPALA's parameters are on {trainer.params['pi']['w'].device}")
        results, f = _rl_run(trainer, iters, trainer, "_next_unrolls")
        steps = sum(r["env_steps_this_iter"] for r in results)
        last = results[-1]
        f.update(env_steps=steps, env_steps_per_s=steps / f["wall_s"],
                 updates_per_s=iters / f["wall_s"], updates_per_learner_s=iters / f["learner_s"],
                 episode_return_mean=last["episode_return_mean"], mean_rho=last["mean_rho"],
                 loss=last["loss"])
        print(f"rl_platform {label} IMPALA on {trainer.device}: {iters} iterations in "
              f"{f['wall_s']:.3f} s ({f['s_per_iter'] * 1e3:.1f} ms each), {steps} env steps "
              f"({f['env_steps_per_s']:.0f}/s), {iters} updates ({f['updates_per_s']:.1f}/s of "
              f"wall, {f['updates_per_learner_s']:.1f}/s of learner time); waiting for unrolls "
              f"{f['sample_s']:.3f} s, learner {f['learner_s']:.3f} s; episode_return_mean "
              f"{f['episode_return_mean']}, mean_rho {f['mean_rho']:.4f}", flush=True)
        require(np.isfinite(f["mean_rho"]) and f["mean_rho"] > 0,
                f"rl_platform {label}: mean_rho {f['mean_rho']}")
    finally:
        trainer.stop()
    return f


def phase_rl_platform(ctx):
    import gc

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import DQNConfig, ImpalaConfig

    gc.collect()
    torch.cuda.empty_cache()
    out = {"a": _rl_updates(torch)}
    if rt.is_initialized():
        rt.shutdown()
    rt.init(num_cpus=8)
    try:
        # (b) tests/test_rl_platform.py's learning runs, learners on the card
        dqn_b = _rl_dqn(rt, DQNConfig(
            env="Chain-rt", env_config=RL_CHAIN, hidden=(32,), num_runners=2, rollout_steps=64,
            buffer_capacity=5_000, learning_starts=128, batch_size=32, updates_per_iter=16,
            epsilon_decay_iters=10, target_sync_interval=4, seed=0), 18, "(b)")
        imp_b = _rl_impala(ImpalaConfig(
            env="Chain-rt", env_config=RL_CHAIN, hidden=(32,), num_runners=2, unroll_len=20,
            batch_unrolls=4, entropy_coef=0.02, lr=3e-3, seed=0), 30, "(b)", 2_000)
        out["b"] = {"dqn": dqn_b, "impala": imp_b}
        require(dqn_b["episode_return_mean"] is not None and dqn_b["episode_return_mean"] > 50,
                f"rl_platform (b): DQN episode_return_mean {dqn_b['episode_return_mean']} <= 50")
        require(imp_b["episode_return_mean"] is not None and imp_b["episode_return_mean"] > 30,
                f"rl_platform (b): IMPALA episode_return_mean {imp_b['episode_return_mean']} "
                f"<= 30")
        # (c) full width: DQNConfig() and ImpalaConfig() on CartPole-rt, 2 runners;
        # (d) runs on (c)'s DQN trainer
        out["c"] = {"dqn": _rl_dqn(rt, DQNConfig(), RL_FULL_ITERS, "(c)"),
                    "impala": _rl_impala(ImpalaConfig(), RL_FULL_ITERS, "(c)", 1_000)}
    finally:
        rt.shutdown()
    print(f"rl_platform on {ctx['card']} ({ctx['smi']}): done", flush=True)
    ctx["rl_platform"] = out


# --------------------------------------------------------------------------- #
# c5: K4 at any GQA group and at D256; fp32 (and bf16 at D256) through the
# CUDA-core kernels of attention_simt.cu; llama_1b's width at 2 layers served
# and trained in those shapes and dtypes
# --------------------------------------------------------------------------- #
SIMT_SRC = "ray_tpu_torch/csrc/attention_simt.cu"
# fp32 kernels against their plain versions (fp32 math, full fp32 products):
# the JAX tests' fp32 flash tolerance (tests/test_ops_attention.py),
# elementwise |kernel - plain| <= F32_TOL + F32_TOL |plain|
F32_TOL = 2e-5
# fp32 FLOP/s on the CUDA cores (NVIDIA's data sheets, dense): the fp32
# SIMT kernels' bound is their operations at this rate; the bf16 instances'
# is at the card's bf16 tensor-core peak, the peak for their inputs' type
FP32_FLOPS = {"H100 SXM": 67e12, "H100 PCIe": 51e12, "H200 SXM": 67e12}
# K4's widened shapes (nh, n_kv, D): groups 1, 2, 8, 16 and 32 at D128, group
# 4 at D256
C5_K4 = ((16, 16, 128), (16, 8, 128), (16, 2, 128), (16, 1, 128), (32, 1, 128), (16, 4, 256))
C5_LAYERS = 2
# the c5 engines' prefill (8 prompts in the 128 bucket) and the c5 train
# step's attention (llama_1b's heads, B2 S512): where the SIMT kernels are
# timed
C5_PREFILL_ATTN = (8, 128, 128, 16, 4, 128, True)
C5_PREFILL_D256 = (8, 128, 128, 8, 2, 256, True)
C5_TRAIN_ATTN = (2, 512, 512, 16, 4, 128, True)
C5_ENGINE_KW = dict(paged=True, num_slots=8, page_size=64, decode_chunk=8, max_seq_len=512,
                    prefill_buckets=[128])
# fp32 training, kernels against the plain path: both fp32, only the order
# of the attention sums differs (F32_TOL-level outputs). Each loss within
# C5_LOSS_RTOL; each gradient leaf within C5_GRAD_RTOL in relative norm,
# ||kernels - plain|| / ||plain|| (the JAX tests' fp32 gradient tolerance)
C5_LOSS_RTOL = 1e-5
C5_GRAD_RTOL = 1e-4


def _f32_ratio(out, ref) -> float:
    """max |out - ref| / (F32_TOL + F32_TOL |ref|): the check passes at <= 1."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() / (F32_TOL + F32_TOL * ref.abs())).max().item()


def _case(torch, shape, seed, dtype):
    b, sq, skv, hq, hkv, d, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(s, generator=g, device="cuda").to(dtype)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]


def phase_c5(ctx):
    import collections
    import threading

    import torch

    others = collections.Counter(t.name.split("-")[0] for t in threading.enumerate()
                                 if t is not threading.main_thread())
    print(f"c5: threads alive besides the main one (by name prefix): {dict(others)}",
          flush=True)

    # the plain versions in full fp32 (torch's default; stated, not assumed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx["c5"] = {"k4_widened": _c5_paged_widened(ctx)}
    _c5_simt_kernels(ctx)
    _c5_serve(ctx)
    _c5_train(ctx)


def _c5_paged_widened(ctx):
    """K4 at each C5_K4 shape, bf16, against its plain version at the serving
    table (64 slots of 1..512 rows, page size 64, 32-page rows) and at a
    ragged long shape (4 slots of 1537..2048 rows); twice, bitwise equal;
    timed at the serving table, event-timed (``ms``) and inside a CUDA
    graph (``device_ms``: the device alone, without the wrapper's host
    time), beside its plain version (``plain_ms``). Each shape's numbers
    also go on K4's entry of the kernels line, keys suffixed ``_g<group>_d<D>``."""
    import torch

    from ray_tpu_torch.models import paged_decode as pd

    out = {}
    for nh, nkv, D in C5_K4:
        errs = []
        for B, lo, hi, total, trash, seed in ((64, 1, 512, 513, 4, 90), (4, 1537, 2048, 129, 0, 91)):
            args = _paged_inputs(torch, seed + nh + nkv, B, lo, hi, total, trash, nh, nkv, D)
            got, again = pd.paged_attention(*args), pd.paged_attention(*args)
            ref = pd._paged_attention_reference(*args, 1.0)
            torch.cuda.synchronize()
            ratio = close_ratio(got, ref)
            errs.append((got.float() - ref.float()).abs().max().item())
            require(bool(torch.isfinite(got).all()) and ratio <= 1.0,
                    f"c5 paged_attention nh{nh} n_kv{nkv} D{D} B{B}: ratio {ratio}")
            require(torch.equal(got, again), f"c5 paged_attention nh{nh} n_kv{nkv} D{D} B{B}: "
                    "two launches differ")
            del args, got, again, ref
        sets = [_paged_inputs(torch, 95 + i, 64, 1, 512, 513, 4, nh, nkv, D) for i in range(2)]
        ms = cuda_ms(torch, pd.paged_attention, sets)
        dev_ms = graph_ms(torch, pd.paged_attention, sets)
        plain_ms = cuda_ms(torch, lambda *a: pd._paged_attention_reference(*a, 1.0), sets,
                           iters=5)
        rows = sum(int(a[4].sum()) for a in sets) / len(sets)
        bms, by = bound_ms(4.0 * nh * D * rows, 2.0 * (2 * 64 * nh * D + 2 * rows * nkv * D)
                           + 4.0 * 64 * 33, ctx["peaks"])
        key = f"g{nh // nkv}_d{D}"
        out[key] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "library_ms": None, "max_abs_err": max(errs), "nh": nh,
                    "n_kv": nkv, "D": D}
        ctx["k4"].update({f"{k}_{key}": out[key][k] for k in
                          ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                           "max_abs_err")})
        ctx["k4"][f"shape_{key}"] = [64, nh, nkv, D, 64, 32, 1, 512]
        print(f"c5 paged_attention group {nh // nkv} (nh {nh}, n_kv {nkv}) D{D}: max_abs_err "
              f"{max(errs):.3e} (atol {KERNEL_ATOL} + rtol {KERNEL_RTOL} |plain|), bitwise "
              f"repeatable; 64 slots: {ms:.5f} ms, device (graph) {dev_ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, bound {bms:.5f} ms ({by}) on {ctx['card']}", flush=True)
        del sets
        torch.cuda.empty_cache()
    return out


def _c5_simt_kernels(ctx):
    """Every SIMT kernel against its plain version: fp32 at D64/128/256
    (F32_TOL), bf16 at D256 (the bf16 tolerances of the kernels phase); then
    each timed at the c5 paths' shapes, beside its plain version, SDPA where
    one call computes the same function, and its fp32 bound."""
    import torch

    from ray_tpu_torch.models import paged_decode as pd
    from ray_tpu_torch.ops import attention as ta

    errs = {k: [] for k in ("k1s", "k1ls", "k2s", "k3s", "k4s")}
    cases = [(dtype, (b, sq, skv, hq, hkv, d, causal))
             for d in (64, 128, 256)
             for dtype, b, sq, skv, hq, hkv, causal in (
                 (torch.float32, 2, 100, 300, 8, 2, True), (torch.float32, 2, 77, 50, 4, 1, False),
                 (torch.float32, 1, 129, 129, 4, 4, True))]
    cases += [(torch.bfloat16, (2, 100, 300, 8, 2, 256, True)),
              (torch.bfloat16, (1, 196, 196, 4, 4, 256, False))]
    for i, (dtype, shape) in enumerate(cases):
        causal, scale = shape[-1], shape[5] ** -0.5
        q, k, v, dout = _case(torch, shape, 200 + i, dtype)
        f32 = dtype == torch.float32
        out = ta.flash_attention(q, k, v, causal=causal)
        out_l, lse, out_lo = ta.flash_attention_lse(q, k, v, causal)
        delta = ta._delta(out_l, dout, out_lo)
        dq = ta.flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
        dk, dv = ta.flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale)
        torch.cuda.synchronize()
        ref, ref_lse, _ = ta.reference_attention_lse(q, k, v, causal)
        ref_dq = ta.flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal, scale)
        ref_dk, ref_dv = ta.flash_bwd_dkv_reference(q, k, v, dout, lse, delta, causal, scale)
        lse_ratio = ((lse - ref_lse).abs() / (LSE_ATOL + LSE_RTOL * ref_lse.abs())).max().item()
        checks = [("k1s", "flash_fwd_simt out", out, ref), ("k1ls", "flash_fwd_lse_simt out", out_l, ref),
                  ("k2s", "flash_bwd_dq_simt dq", dq, ref_dq),
                  ("k3s", "flash_bwd_dkv_simt dk", dk, ref_dk), ("k3s", "flash_bwd_dkv_simt dv", dv, ref_dv)]
        for key, what, got, want in checks:
            ratio = (_f32_ratio(got, want) if f32 else
                     close_ratio(got, want) if key in ("k1s", "k1ls") else _grad_ratio(got, want))
            err = (got.float() - want.float()).abs().max().item()
            errs[key].append(err)
            require(bool(torch.isfinite(got).all()) and ratio <= 1.0,
                    f"c5 {what} {dtype} {shape}: worst error / tolerance {ratio}")
        require((_f32_ratio(lse, ref_lse) if f32 else lse_ratio) <= 1.0,
                f"c5 flash_fwd_lse_simt lse {dtype} {shape} disagrees")
        require(not f32 or not out_lo.any(), "c5: fp32 out_lo is not zero")
        print(f"c5 SIMT flash kernels {str(dtype)[6:]} {shape}: max_abs_err out "
              f"{errs['k1s'][-1]:.3e}, dq {errs['k2s'][-1]:.3e}, dk/dv {errs['k3s'][-1]:.3e} "
              f"(tol {'atol = rtol = ' + str(F32_TOL) if f32 else 'bf16'})", flush=True)
        del q, k, v, dout, out, out_l, lse, out_lo, delta, dq, dk, dv, ref, ref_lse, ref_dq, \
            ref_dk, ref_dv
    for nh, nkv, D in ((8, 2, 64), (16, 4, 128), (16, 16, 128), (8, 2, 256)):
        args = _paged_inputs(torch, 300 + D + nkv, 8, 1, 512, 65, 1, nh, nkv, D,
                             dtype=torch.float32)
        got, ref = pd.paged_attention(*args), pd._paged_attention_reference(*args, 1.0)
        torch.cuda.synchronize()
        ratio = _f32_ratio(got, ref)
        errs["k4s"].append((got - ref).abs().max().item())
        print(f"c5 paged_attention_simt fp32 nh{nh} n_kv{nkv} D{D}: max_abs_err "
              f"{errs['k4s'][-1]:.3e}, worst error / tolerance {ratio:.3f}", flush=True)
        require(ratio <= 1.0, f"c5 paged_attention_simt fp32 D{D} disagrees: {ratio}")
    torch.cuda.empty_cache()
    _c5_time_simt(ctx, errs)


def _c5_time_simt(ctx, errs):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.models import paged_decode as pd
    from ray_tpu_torch.ops import attention as ta

    f32_peaks = (FP32_FLOPS[ctx["peaks_key"]], ctx["peaks"][1])

    def sdpa_fwd(q, k, v, causal):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=causal,
                                              enable_gqa=True)

    def work(shape, esize):
        b, sq, skv, hq, hkv, d, causal = shape
        pairs = _visible_pairs(sq, skv, causal)
        q_el, kv_el, rows = b * sq * hq * d, b * skv * hkv * d, b * hq * sq
        return {"fwd": (4.0 * b * hq * d * pairs, esize * (2 * q_el + 2 * kv_el)),
                "fwd_lse": (4.0 * b * hq * d * pairs, esize * (3 * q_el + 2 * kv_el) + 4.0 * rows),
                "dq": (6.0 * b * hq * d * pairs, esize * (3 * q_el + 2 * kv_el) + 8.0 * rows),
                "dkv": (8.0 * b * hq * d * pairs, esize * (2 * q_el + 4 * kv_el) + 8.0 * rows)}

    def timed(shape, dtype, seed, peaks, esize):
        causal, scale = shape[-1], shape[5] ** -0.5
        sets = []
        for i in range(2):
            q, k, v, dout = _case(torch, shape, seed + i, dtype)
            out, lse, out_lo = ta.flash_attention_lse(q, k, v, causal)
            sets.append((q, k, v, dout, lse, ta._delta(out, dout, out_lo)))
        graphs = []
        for q, k, v, dout, _, _ in sets:
            leaves = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
            graphs.append((o, leaves, dout.transpose(1, 2)))
        lib_bwd = cuda_ms(torch, lambda o, leaves, g: torch.autograd.grad(
            o, leaves, g, retain_graph=True), graphs, iters=5, warmup=1)
        lib_fwd = cuda_ms(torch, lambda q, k, v, *_: sdpa_fwd(q, k, v, causal), sets, iters=5,
                          warmup=1)
        fns = {"fwd": (lambda q, k, v, *_: ta.flash_attention(q, k, v, causal),
                       lambda q, k, v, *_: ta.reference_attention(q, k, v, causal), lib_fwd),
               "fwd_lse": (lambda q, k, v, *_: ta.flash_attention_lse(q, k, v, causal),
                           lambda q, k, v, *_: ta.reference_attention_lse(q, k, v, causal),
                           lib_fwd),
               "dq": (lambda *a: ta.flash_bwd_dq(*a, causal, scale),
                      lambda *a: ta.flash_bwd_dq_reference(*a, causal, scale), lib_bwd),
               "dkv": (lambda *a: ta.flash_bwd_dkv(*a, causal, scale),
                       lambda *a: ta.flash_bwd_dkv_reference(*a, causal, scale), lib_bwd)}
        res = {}
        for name, (fn, plain, lib) in fns.items():
            ms = cuda_ms(torch, fn, sets, iters=5, warmup=1)
            plain_ms = cuda_ms(torch, plain, sets, iters=3, warmup=1)
            bms, by = bound_ms(*work(shape, esize)[name], peaks)
            res[name] = (ms, plain_ms, lib, bms, by)
            print(f"c5 {name} SIMT {str(dtype)[6:]} {shape}: {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, SDPA {lib:.4f} ms ({'forward' if name.startswith('fwd') else 'backward, dq dk dv together'}), "
                  f"bound {bms:.4f} ms ({by}) on {ctx['card']}", flush=True)
        del sets, graphs
        torch.cuda.empty_cache()
        return res

    prefill = timed(C5_PREFILL_ATTN, torch.float32, 400, f32_peaks, 4.0)
    train = timed(C5_TRAIN_ATTN, torch.float32, 410, f32_peaks, 4.0)
    d256 = timed(C5_PREFILL_D256, torch.bfloat16, 420, ctx["peaks"], 2.0)
    meta = {"k1s": ("flash_fwd_simt", "ray_tpu/ops/attention.py:71", prefill["fwd"],
                    C5_PREFILL_ATTN),
            "k1ls": ("flash_fwd_lse_simt", "ray_tpu/ops/attention.py:155", train["fwd_lse"],
                     C5_TRAIN_ATTN),
            "k2s": ("flash_bwd_dq_simt", "ray_tpu/ops/attention.py:182", train["dq"],
                    C5_TRAIN_ATTN),
            "k3s": ("flash_bwd_dkv_simt", "ray_tpu/ops/attention.py:224", train["dkv"],
                    C5_TRAIN_ATTN)}
    for key, (name, replaces, (ms, plain_ms, lib, bms, by), shape) in meta.items():
        sub = d256["fwd" if key == "k1s" else "fwd_lse" if key == "k1ls" else
                   "dq" if key == "k2s" else "dkv"]
        ctx[key] = {"name": name, "route": "cuda", "source": SIMT_SRC, "replaces": replaces,
                    "max_abs_err": max(errs[key]), "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by, "library_ms": lib, "shape": list(shape),
                    "ms_bf16_d256": sub[0], "plain_ms_bf16_d256": sub[1],
                    "library_ms_bf16_d256": sub[2], "bound_ms_bf16_d256": sub[3],
                    "bound_by_bf16_d256": sub[4],
                    "shape_bf16_d256": list(C5_PREFILL_D256)}
    # paged_attention_simt at the c5 fp32 engine's decode: 8 slots of
    # llama_1b's heads, fp32, 1..512 rows on 64-row pages
    sets = [_paged_inputs(torch, 430 + i, 8, 1, 512, 65, 1, 16, 4, 128, max_pages=8,
                          dtype=torch.float32) for i in range(2)]
    ms = cuda_ms(torch, pd.paged_attention, sets)
    plain_ms = cuda_ms(torch, lambda *a: pd._paged_attention_reference(*a, 1.0), sets, iters=5)
    rows = sum(int(a[4].sum()) for a in sets) / len(sets)
    bms, by = bound_ms(4.0 * 16 * 128 * rows, 4.0 * (2 * 8 * 16 * 128 + 2 * rows * 4 * 128)
                       + 4.0 * 8 * 9, f32_peaks)
    ctx["k4s"] = {"name": "paged_attention_simt", "route": "cuda", "source": SIMT_SRC,
                  "replaces": "ray_tpu/models/paged_decode.py:93", "max_abs_err": max(errs["k4s"]),
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                  "library_ms": None, "shape": [8, 16, 4, 128, 64, 8, 1, 512]}
    print(f"c5 paged_attention_simt fp32 8 slots: {ms:.5f} ms, plain {plain_ms:.5f} ms, bound "
          f"{bms:.5f} ms ({by}) on {ctx['card']}", flush=True)
    del sets
    torch.cuda.empty_cache()


def _c5_configs():
    """llama_1b's width at C5_LAYERS layers in the shapes and dtypes fault C5
    was about (dataclasses.replace: the preset already passes num_kv_heads)."""
    import dataclasses

    import torch

    from ray_tpu_torch.models.llama import LlamaConfig

    base = dataclasses.replace(LlamaConfig.llama_1b(max_seq_len=512), num_layers=C5_LAYERS)
    return {"mha_bf16": dataclasses.replace(base, num_kv_heads=16),
            "group8_bf16": dataclasses.replace(base, num_kv_heads=2),
            "d256_bf16": dataclasses.replace(base, num_heads=8, num_kv_heads=2, head_dim=256),
            "group4_fp32": dataclasses.replace(base, dtype=torch.float32)}


def _c5_serve(ctx):
    """LLMEngine answers 8 greedy requests for each _c5_configs entry: every
    prefill program launches the forward kernel and every decode tick the
    decode kernel once a layer (the tensor-core kernels in bf16 at D128, the
    SIMT forward at D256 and in fp32, the SIMT decode in fp32), no call runs
    a plain version, and the fp32 tokens equal those of the same engine
    through the plain versions."""
    import torch

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.models import paged_decode as pd
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.ops import attention as ta
    from ray_tpu_torch.serve.llm import LLMEngine

    rng = torch.Generator().manual_seed(11)
    bf16_counts, simt_counts = {}, {}
    for name, cfg in _c5_configs().items():
        params = llama_init(cfg, seed=0, device="cuda")
        prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
                   for n in (32, 48, 64, 80, 96, 112, 128, 40)]

        def serve():
            engine = LLMEngine(cfg, params, device="cuda", **C5_ENGINE_KW)
            try:
                engine.generate(prompts[0], max_tokens=2, timeout=600)  # warm-up
                torch.cuda.synchronize()
                s0 = engine.stats()
                _kernels.reset_counts()
                with ThreadPoolExecutor(max_workers=len(prompts)) as pool:
                    futs = [pool.submit(engine.generate, p, 16, None, 600) for p in prompts]
                    tokens = [f.result()["tokens"] for f in futs]
                torch.cuda.synchronize()
                counts = dict(_kernels.launch_counts)
                s1 = engine.stats()
            finally:
                engine.stop()
            return (tokens, counts, s1["prefill_programs"] - s0["prefill_programs"],
                    s1["decode_steps"] - s0["decode_steps"])

        tokens, counts, programs, ticks = serve()
        fp32 = cfg.dtype == torch.float32
        fwd = "flash_fwd_simt" if fp32 or cfg.head_dim_ == 256 else "flash_fwd"
        dec = "paged_attention_simt" if fp32 else "paged_attention"
        want = {fwd: C5_LAYERS * programs, dec: C5_LAYERS * ticks}
        require_no_plain(counts, f"c5 serve {name}")
        require(counts == want, f"c5 serve {name} launched {counts}, expected {want}")
        require(all(len(t) == 16 and all(0 <= x < cfg.vocab_size for x in t) for t in tokens),
                f"c5 serve {name}: a request returned wrong tokens")
        line = (f"c5 serve {name} (nh {cfg.num_heads}, n_kv {cfg.num_kv_heads}, D "
                f"{cfg.head_dim_}, {str(cfg.dtype)[6:]}, {C5_LAYERS} layers): 8 requests x 16 "
                f"tokens, {programs} prefill programs, {ticks} decode ticks, launches {counts}")
        if fp32:
            _kernels.reset_counts()
            with mock.patch.object(ta, "flash_attention",
                                   lambda q, k, v, causal=True, scale=None:
                                   ta.reference_attention(q, k, v, causal, scale)), \
                    mock.patch.object(pd, "paged_attention",
                                      lambda *a: pd._paged_attention_reference(*a, 1.0)):
                plain_tokens = serve()[0]
            require_no_launches(_kernels.launch_counts, "c5 serve plain")
            same = sum(a == b for a, b in zip(tokens, plain_tokens))
            line += f"; greedy tokens equal to the plain path's in {same} of 8 requests"
            require(same == len(tokens), f"c5 serve {name}: tokens differ from the plain path")
        print(line, flush=True)
        for n, c in counts.items():
            target = simt_counts if n.endswith("_simt") else bf16_counts
            target[n] = target.get(n, 0) + c
        ctx["c5"][f"serve_{name}"] = {"prefill_programs": programs, "decode_ticks": ticks,
                                      "launches": counts}
        del params
        torch.cuda.empty_cache()
    ctx["c5_serve_launches"], ctx["c5_bf16_launches"] = simt_counts, bf16_counts


def _c5_train(ctx):
    """fp32 training of llama_1b's width at C5_LAYERS layers (save_attn, B2
    S512) through the SIMT forward with lse, dQ and dK/dV, held against the
    same work through the plain versions (flash_attention_lse and flash_bwd
    patched to their references), each from the seed-0 state: the first
    step's gradients, leaf by leaf, within C5_GRAD_RTOL in relative norm;
    then 3 train steps at a nonzero learning rate from the first update
    (warmup_steps=0), each loss within C5_LOSS_RTOL of the plain run's. Each
    kernel step launches each SIMT kernel once a layer; no call runs a
    plain version, and the plain run launches nothing."""
    import contextlib
    import dataclasses
    import math

    import numpy as np
    import torch

    from ray_tpu_torch import _kernels
    from ray_tpu_torch.models.llama import llama_loss
    from ray_tpu_torch.ops import attention as ta
    from ray_tpu_torch.train.step import (default_optimizer, make_train_state_factory,
                                          make_train_step)

    cfg = dataclasses.replace(_c5_configs()["group4_fp32"], remat="save_attn")
    opt = default_optimizer(warmup_steps=0, total_steps=100)
    rng = np.random.default_rng(3)
    b, s = C5_TRAIN_ATTN[0], C5_TRAIN_ATTN[1]
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()
    targets = torch.roll(tokens, -1, dims=1)
    step = make_train_step(cfg, opt)
    factory = make_train_state_factory(cfg, opt)
    want = {"flash_fwd_lse_simt": C5_LAYERS, "flash_bwd_dq_simt": C5_LAYERS,
            "flash_bwd_dkv_simt": C5_LAYERS}

    def run(plain: bool):
        """(names, first-step gradients, 3 losses, launches of the 3 steps,
        seconds of the 3 steps) from the seed-0 state."""
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(mock.patch.object(ta, "flash_attention_lse",
                                                      ta.reference_attention_lse))
                stack.enter_context(mock.patch.object(ta, "flash_bwd", ta.flash_bwd_reference))
            state = factory(seed=0, device="cuda")
            names, leaves = grad_leaves(state.params)
            _kernels.reset_counts()
            with torch.enable_grad():
                loss = llama_loss(state.params, tokens.long(), targets.long(), cfg)
                grads = [g.detach() for g in torch.autograd.grad(loss, leaves)]
            require(dict(_kernels.launch_counts) == ({} if plain else want),
                    f"c5 train gradients ({'plain' if plain else 'kernels'}) launched "
                    f"{dict(_kernels.launch_counts)}")
            del loss, leaves
            losses = []
            _kernels.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(3):
                before = dict(_kernels.launch_counts)
                state, metrics = step(state, tokens, targets)
                losses.append(metrics["loss"].item())
                counts = {n: c - before.get(n, 0) for n, c in _kernels.launch_counts.items()
                          if c != before.get(n, 0)}
                require(math.isfinite(losses[-1]), f"c5 train step {i}: non-finite loss")
                require(counts == ({} if plain else want),
                        f"c5 train step {i} ({'plain' if plain else 'kernels'}) launched "
                        f"{counts}, expected {({} if plain else want)}")
            dt = time.perf_counter() - t0
            launches = dict(_kernels.launch_counts)
        del state
        return names, grads, losses, launches, dt

    _, grads_p, plain_losses, _, plain_dt = run(plain=True)
    torch.cuda.empty_cache()
    names, grads_k, losses, launches, dt = run(plain=False)
    require_no_plain(launches, "c5 train")
    worst, worst_name = 0.0, None
    for name, gk, gp in zip(names, grads_k, grads_p):
        require(bool(torch.isfinite(gk).all()), f"c5 train: non-finite gradient {name}")
        rel = ((gk - gp).norm() / gp.norm().clamp_min(1e-30)).item()
        if rel >= worst:
            worst, worst_name = rel, name
    del grads_k, grads_p
    rels = [abs(a - p) / abs(p) for a, p in zip(losses, plain_losses)]
    print(f"c5 train fp32 llama_1b width, {C5_LAYERS} layers, B{b} S{s}, save_attn, lr "
          f"{opt.schedule(0)} from the first update: first-step gradients, worst leaf "
          f"{worst_name} at relative norm {worst:.3e} (tol {C5_GRAD_RTOL}); losses {losses}, "
          f"plain {plain_losses}, relative {[f'{r:.3e}' for r in rels]} (tol {C5_LOSS_RTOL}); "
          f"{dt / 3 * 1e3:.1f} ms a step (plain {plain_dt / 3 * 1e3:.1f}); launches "
          f"{launches}", flush=True)
    require(worst <= C5_GRAD_RTOL, f"c5 train gradient {worst_name} disagrees with the plain "
            f"path: {worst}")
    require(max(rels) <= C5_LOSS_RTOL, f"c5 train losses disagree with the plain path: {rels}")
    require(losses[1] != losses[0] and plain_losses[1] != plain_losses[0],
            "c5 train: the first update did not move the loss")
    ctx["c5"]["train"] = {"losses": losses, "plain_losses": plain_losses, "rel": rels,
                          "grad_rel_norm": worst, "grad_worst_leaf": worst_name,
                          "step_ms": dt / 3 * 1e3, "plain_step_ms": plain_dt / 3 * 1e3,
                          "launches": launches}
    ctx["c5_train_launches"] = launches
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# data: ray_tpu_torch.data feeding ViT-L/16 on the card
# --------------------------------------------------------------------------- #
DATA_IMAGES, DATA_STEPS, DATA_BATCH = 512, 20, 32


def phase_data(ctx):
    """512 seeded 224 px PNGs through read_images, map_batches(normalize),
    streaming_split(1) and iter_torch_batches(batch_size=32) into 20 ViT-L/16
    train steps (ray_tpu_torch.bench_data_train); every step launches K1',
    K2 and K3 once a layer and no plain version; the first 3 losses are
    bit-equal to the same batches fed to the step directly; then one
    2-worker GpuTrainer(datasets=...) run on CPU workers over the same
    pipeline, counting rows."""
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import _kernels
    from ray_tpu_torch.bench_data_train import data_train, image_pipeline, write_corpus
    from ray_tpu_torch.models import vit as tv
    from ray_tpu_torch.train.config import RunConfig, ScalingConfig
    from ray_tpu_torch.train.step import adamw
    from ray_tpu_torch.train.trainer import GpuTrainer

    torch.cuda.empty_cache()
    cfg = tv.ViTConfig.vit_l(image_size=224)
    L = cfg.num_layers
    corpus = tempfile.mkdtemp(prefix="chip_smoke_images_")
    try:
        t0 = time.perf_counter()
        write_corpus(corpus, DATA_IMAGES, 224)
        corpus_s = time.perf_counter() - t0
        _kernels.reset_counts()
        res, extras = data_train(DATA_IMAGES, DATA_STEPS, DATA_BATCH, keep=3, corpus=corpus)
        launches = dict(_kernels.launch_counts)
        require_no_plain(launches, "data")
        want = {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
        for i, c in enumerate(extras["launches"]):
            require(c == want, f"data step {i} launched {c}, expected {want}")
        losses = [loss.item() for loss in extras["losses"]]
        require(len(losses) == DATA_STEPS and all(math.isfinite(x) for x in losses),
                f"data: {len(losses)} steps, losses {losses}")
        print("data per-op pipeline stats (the last epoch's execution):\n"
              + extras["stats_table"], flush=True)
        print(f"data on {ctx['card']} ({ctx['smi']}): {DATA_IMAGES} PNGs (written in "
              f"{corpus_s:.2f} s) -> read_images -> map_batches(normalize) -> "
              f"streaming_split(1) -> iter_torch_batches(batch_size={DATA_BATCH}) -> ViT-L/16 "
              f"({cfg.num_params} params) for {res['steps']} steps: {res['value']} images/s, "
              f"busy fraction {res['vs_baseline']}, input-starved fraction "
              f"{res['input_starved_fraction']}, peak in-flight blocks "
              f"{res['peak_in_flight_blocks']}; losses {losses}", flush=True)

        # the first 3 losses, bit for bit, from the same batches fed directly
        step, init = tv.make_vit_train_step(cfg, adamw(1e-3))
        params, opt_state = init(seed=0, device="cuda")
        warm, *timed = extras["batches"]
        params, opt_state, _ = step(params, opt_state, warm["image"], warm["label"])
        direct = []
        for b in timed:
            params, opt_state, loss = step(params, opt_state, b["image"], b["label"])
            direct.append(loss)
        equal = [torch.equal(a, b) for a, b in zip(extras["losses"], direct)]
        print(f"data: the first {len(direct)} losses through iter_torch_batches "
              f"{[x.item() for x in extras['losses'][:3]]}, fed directly "
              f"{[x.item() for x in direct]}: bit-equal {equal}", flush=True)
        require(len(equal) == 3 and all(equal), "data: losses differ from direct feeding")
        del params, opt_state, extras, direct, timed, warm
        torch.cuda.empty_cache()

        # one GpuTrainer run, 2 CPU workers, each reading its streaming_split shard
        def train_fn(config):
            from ray_tpu_torch.train import session

            it = session.get_dataset_shard("train")
            session.report({"rows": sum(len(b["label"]) for b in it.iter_batches(batch_size=32))})

        ray_tpu_torch.init(num_cpus=8)
        try:
            t0 = time.perf_counter()
            result = GpuTrainer(
                train_fn, scaling_config=ScalingConfig(num_workers=2, cpus_per_worker=1),
                run_config=RunConfig(name="data_train", storage_path=os.path.join(corpus, "runs")),
                datasets={"train": image_pipeline(corpus, 224, cfg.num_classes)}).fit()
            trainer_s = time.perf_counter() - t0
        finally:
            ray_tpu_torch.shutdown()
        rows = (result.metrics or {}).get("rows", 0)
        print(f"data: GpuTrainer, 2 CPU workers, datasets={{'train': ...}}: error "
              f"{result.error!r}, worker 0 read {rows} rows of {DATA_IMAGES} in "
              f"{trainer_s:.2f} s", flush=True)
        require(result.error is None and 0 < rows <= DATA_IMAGES,
                f"data: GpuTrainer run failed or read {rows} rows")
    finally:
        shutil.rmtree(corpus, ignore_errors=True)
    ctx["data"] = dict(res, losses=losses, corpus_s=corpus_s, trainer_rows=rows,
                       trainer_s=trainer_s)
    ctx["data_launches"] = launches


# --------------------------------------------------------------------------- #
# cluster: the multi-process runtime (GCS, node agent, worker processes)
# --------------------------------------------------------------------------- #
CLUSTER_TENSOR_BYTES = 256 * 1024 * 1024  # (b)'s bf16 tensor through the store


def _cluster_policy_server():
    """A line-JSON external placement policy (the protocol of
    core/gcs/external_policy.py, as tests/test_cluster_external_policy.py
    serves it): places every request on the first node it was told of and
    records every batch."""
    import json as _json
    import socket
    import threading

    state = {"nodes": [], "batches": [], "lock": threading.Lock()}
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(4)

    def serve():
        try:
            conn, _ = sock.accept()
        except OSError:
            return
        buf = b""
        while True:
            try:
                data = conn.recv(65536)
            except OSError:
                return
            if not data:
                return
            buf += data
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                msg = _json.loads(line)
                with state["lock"]:
                    if msg["op"] == "add_node":
                        state["nodes"].append(msg["node_id"])
                    elif msg["op"] == "schedule":
                        state["batches"].append(msg)
                        pin = state["nodes"][0] if state["nodes"] else None
                        conn.sendall((_json.dumps({"batch_id": msg["batch_id"], "placements":
                                                   [pin for _ in msg["requests"]]}) + "\n").encode())

    threading.Thread(target=serve, daemon=True, name="policy-server").start()
    return sock, state


def _cluster_workers(ctx, rt, torch, out):
    """cluster (b): a GPU task sees one card and computes on it, a CPU task
    sees none, a bf16 CUDA tensor through the store both ways."""
    @rt.remote(num_gpus=1)
    def gpu_probe():
        import os
        import sys

        import torch

        a = torch.randn(1024, 1024, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "count": torch.cuda.device_count(), "name": torch.cuda.get_device_name(0),
                "device": str((a @ a).device), "sum": float((a @ a).float().sum()),
                "jax_package": sorted({m.split(".")[0] for m in sys.modules}
                                      & {"ray_tpu", "jax"})}

    @rt.remote
    def cpu_probe():
        import os
        import sys

        import torch

        return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "cuda": torch.cuda.is_available(),
                "jax_package": sorted({m.split(".")[0] for m in sys.modules}
                                      & {"ray_tpu", "jax"})}

    t0 = time.perf_counter()
    g = rt.get(gpu_probe.remote(), timeout=300)
    gpu_first_s = time.perf_counter() - t0
    c = rt.get(cpu_probe.remote(), timeout=300)
    a = torch.randn(1024, 1024, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    want_sum = float((a @ a).float().sum())
    print(f"cluster (b) on {ctx['card']} ({ctx['smi']}): num_gpus=1 task (first call "
          f"{gpu_first_s:.3f} s): "
          f"CUDA_VISIBLE_DEVICES={g['visible']!r}, {g['count']} card ({g['name']}), result on "
          f"{g['device']}, sum equal to the driver's {g['sum'] == want_sum}; CPU task: "
          f"CUDA_VISIBLE_DEVICES={c['visible']!r}, cuda available {c['cuda']}; "
          f"JAX package in the workers {g['jax_package']} {c['jax_package']}", flush=True)
    require(g["visible"] == "0" and g["count"] == 1 and g["device"].startswith("cuda")
            and g["name"] == ctx["card"] and g["sum"] == want_sum,
            f"cluster (b): the GPU task saw {g}")
    require(c["visible"] == "" and c["cuda"] is False, f"cluster (b): the CPU task saw {c}")
    require(not g["jax_package"] and not c["jax_package"],
            "cluster (b): a worker process loaded the JAX package")

    @rt.remote(num_gpus=1)
    def gpu_roundtrip(boxed):
        import time

        import torch

        t0 = time.perf_counter()
        x = rt.get(boxed[0])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = rt.put(x)
        put_s = time.perf_counter() - t0
        return {"device": str(x.device), "dtype": str(x.dtype), "load_s": load_s,
                "put_s": put_s, "ref": [ref]}

    n = CLUSTER_TENSOR_BYTES // 2
    x = torch.randn(n, device="cuda", generator=torch.Generator("cuda").manual_seed(4)).to(
        torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = rt.put(x)
    put_s = time.perf_counter() - t0
    r = rt.get(gpu_roundtrip.remote([ref]), timeout=300)
    t0 = time.perf_counter()
    back = rt.get(r["ref"][0], timeout=300)
    torch.cuda.synchronize()
    get_s = time.perf_counter() - t0
    equal = (back.device.type == "cuda" and back.dtype == torch.bfloat16
             and torch.equal(back.view(torch.int16), x.view(torch.int16)))
    gbs = {"driver_put": CLUSTER_TENSOR_BYTES / put_s / 1e9,
           "task_get": CLUSTER_TENSOR_BYTES / r["load_s"] / 1e9,
           "task_put": CLUSTER_TENSOR_BYTES / r["put_s"] / 1e9,
           "driver_get": CLUSTER_TENSOR_BYTES / get_s / 1e9}
    print(f"cluster (b) on {ctx['card']} ({ctx['smi']}): a {CLUSTER_TENSOR_BYTES >> 20} MB bf16 "
          f"CUDA tensor, driver -> store -> GPU task ({r['device']}, {r['dtype']}) -> store -> "
          f"driver: bit-equal {equal}; GB/s driver put (card to shared memory) "
          f"{gbs['driver_put']:.3f}, task get (shared memory to card) {gbs['task_get']:.3f}, "
          f"task put {gbs['task_put']:.3f}, driver get {gbs['driver_get']:.3f}", flush=True)
    require(equal and r["device"].startswith("cuda"),
            "cluster (b): the tensor did not come back bit-equal on the card")
    out["b"] = {"gpu_first_call_s": gpu_first_s, "gb_per_s": gbs,
                "put_s": put_s, "get_s": get_s, "task_load_s": r["load_s"],
                "task_put_s": r["put_s"]}
    del x, back, r, ref


def _cluster_policy(ctx, rt, Cluster, out):
    """cluster (c): a SPREAD num_gpus=1 task placed by an external policy."""
    from ray_tpu_torch.core.resources import SpreadSchedulingStrategy

    sock, state = _cluster_policy_server()
    os.environ["RAY_TPU_EXTERNAL_SCHEDULER_ADDRESS"] = f"127.0.0.1:{sock.getsockname()[1]}"
    try:
        pc = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
    finally:
        os.environ.pop("RAY_TPU_EXTERNAL_SCHEDULER_ADDRESS", None)
    try:
        rt.init(address=pc.gcs_address)

        @rt.remote(num_gpus=1)
        def where():
            return os.environ["RAY_TPU_NODE_ID"], os.environ.get("CUDA_VISIBLE_DEVICES")

        node, visible = rt.get(where.options(scheduling_strategy=SpreadSchedulingStrategy())
                               .remote(), timeout=300)
        with state["lock"]:
            gpu_batches = [b for b in state["batches"]
                           if any((q.get("resources") or {}).get("GPU") == 1
                                  for q in b["requests"])]
            nodes = list(state["nodes"])
        print(f"cluster (c) external policy: saw nodes {[n[:8] for n in nodes]}, "
              f"{len(state['batches'])} batches, {len(gpu_batches)} carrying GPU: 1; the SPREAD "
              f"num_gpus=1 task ran on {node[:8]} with CUDA_VISIBLE_DEVICES={visible!r}",
              flush=True)
        require(gpu_batches and node == nodes[0] and visible == "0",
                f"cluster (c): the policy did not place the GPU task: {state['batches']}")
        out["c"] = {"batches": len(state["batches"]), "gpu_batches": len(gpu_batches)}
    finally:
        rt.shutdown()
        pc.shutdown()
        sock.close()


def _cluster_llm_class():
    """The serve_app deployment, with its replica's launch counts and peak
    memory readable through the handle: they live in the replica's process.
    Defined in a function, so cloudpickle sends it by value."""
    from ray_tpu_torch.serve.llm import LLMDeployment

    class CountedLLM(LLMDeployment):
        def reset_counts(self):
            from ray_tpu_torch import _kernels

            _kernels.reset_counts()
            return True

        def launch_counts(self):
            from ray_tpu_torch import _kernels

            return dict(_kernels.launch_counts)

        def process(self):
            import sys

            import torch

            return {"pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "jax_package": sorted({m.split(".")[0] for m in sys.modules}
                                          & {"ray_tpu", "jax"})}

    return CountedLLM


def _cluster_serve(ctx, rt, out):
    """cluster (d): llama_1b served through serve.run from a GPU replica that
    is a worker process of its own."""
    from ray_tpu_torch import serve

    L = _llama_1b().num_layers
    pr = ctx["serve_app_prompts"]
    n_req, max_tokens = SERVE_APP_REQUESTS, SERVE_APP_TOKENS
    t0 = time.perf_counter()
    # no params: the replica draws llama_init(seed 0) on its card, the
    # weights serve_app (a) drew in this process
    app = (serve.deployment(_cluster_llm_class(), name="llm")
           .options(ray_actor_options={"num_gpus": 1}, max_ongoing_requests=n_req)
           .bind(**SERVE_APP_KW))
    handle = serve.run(app, http=False)
    try:
        deploy_s = time.perf_counter() - t0
        got = [handle.generate.remote({"tokens": p, "max_tokens": max_tokens, "timeout": 600})
               .result(timeout=600)["tokens"] for p in pr["singles"]]
        print(f"cluster (d) on {ctx['card']} ({ctx['smi']}): serve.run, replica in its own "
              f"process (ready in {deploy_s:.3f} s): "
              f"{len(got)} prompts one at a time, tokens equal to serve_app (a)'s direct "
              f"deployment {got == pr['want']}", flush=True)
        require(got == pr["want"], "cluster (d): tokens through the replica process differ "
                f"from the direct deployment's: {[g[:8] for g in got]} against "
                f"{[w[:8] for w in pr['want']]}")
        s0 = handle.engine_stats.remote().result(timeout=60)
        handle.reset_counts.remote().result(timeout=60)
        results, ends, t0 = _run_load(
            lambda r: handle.generate.remote(r).result(timeout=600), pr["prompts"], max_tokens)
        counts = handle.launch_counts.remote().result(timeout=60)
        s1 = handle.engine_stats.remote().result(timeout=60)
        proc = handle.process.remote().result(timeout=60)
    finally:
        serve.shutdown()
    fig = _load_figures(results, ends, t0)
    for r in results:
        require(len(r["tokens"]) == max_tokens,
                f"cluster (d): a request returned {len(r['tokens'])} tokens")
    programs = s1["prefill_programs"] - s0["prefill_programs"]
    ticks = s1["decode_steps"] - s0["decode_steps"]
    require_no_plain(counts, "cluster (d)")
    require(counts.get("flash_fwd") == L * programs and counts.get("paged_attention") == L * ticks
            and programs > 0 and ticks > 0,
            f"cluster (d): the replica launched {counts} against {programs} prefill programs and "
            f"{ticks} decode ticks of {L} layers")
    require(proc["pid"] != os.getpid() and proc["visible"] == "0" and not proc["jax_package"],
            f"cluster (d): the replica's process {proc}")
    launches = {n: counts.get(n, 0) for n in ("flash_fwd", "paged_attention")}
    sa = ctx["serve_app"]
    print(f"cluster (d) on {ctx['card']} ({ctx['smi']}): {n_req} requests together through "
          f"the handle to the replica process: {_fmt_load(fig)}; its launches {launches} "
          f"({programs} prefill programs, {ticks} decode ticks), plain 0; replica peak "
          f"max_memory_allocated {proc['peak_bytes'] / 2**30:.3f} GiB", flush=True)
    print(f"cluster (d) beside the in-process runtime (serve_app): through serve "
          f"{sa['serve']['req_per_s']:.3f} req/s, TTFT p50 {sa['serve']['p50_ttft_s'] * 1e3:.1f} "
          f"ms, latency p50 {sa['serve']['p50_latency_s'] * 1e3:.1f} ms; called directly "
          f"{sa['direct']['req_per_s']:.3f} req/s, TTFT p50 "
          f"{sa['direct']['p50_ttft_s'] * 1e3:.1f} ms, latency p50 "
          f"{sa['direct']['p50_latency_s'] * 1e3:.1f} ms", flush=True)
    out["d"] = {"deploy_s": deploy_s, "serve": fig, "launches": launches,
                "prefill_programs": programs, "decode_ticks": ticks,
                "replica_peak_bytes": proc["peak_bytes"]}
    return launches


def _cluster_train(ctx, rt, tmp, out):
    """cluster (e): the runtime phase's llama_1b loop in GpuTrainer, whose
    one TrainWorker is a worker process on the card."""
    from ray_tpu_torch.train import GpuTrainer, RunConfig, ScalingConfig

    L = _llama_1b().num_layers
    want = {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    n = RUNTIME_WARMUP + RUNTIME_STEPS

    def train_fn(config):
        import os
        import sys

        import torch

        from ray_tpu_torch import train

        def report(rec):
            rec.update(pid=os.getpid(), visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       jax_package=sorted({m.split(".")[0] for m in sys.modules}
                                          & {"ray_tpu", "jax"}))
            train.report(rec)

        _runtime_llama_loop(report)

    t0 = time.perf_counter()
    r = GpuTrainer(train_fn, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                   run_config=RunConfig(name="cluster_llama_1b", storage_path=tmp)).fit()
    fit_s = time.perf_counter() - t0
    require(r.error is None, f"cluster (e): the trainer failed: {r.error!r}")
    history = r.metrics_history
    require(len(history) == n, f"cluster (e): {len(history)} reports, expected {n}")
    for rec in history:
        require(rec["launches"] == want, f"cluster (e) step {rec['step']} launched "
                f"{rec['launches']}, expected {want} and no other kernel")
        require(rec["pid"] != os.getpid() and rec["visible"] == "0" and not rec["jax_package"],
                f"cluster (e): the train worker's process {rec}")
    losses = [rec["loss"] for rec in history]
    direct = ctx["runtime_direct"]
    bit_equal = losses == direct["losses"]
    step_ms = statistics.median(rec["ms"] for rec in history[RUNTIME_WARMUP:])
    launches = {k: v * n for k, v in want.items()}
    print(f"cluster (e) on {ctx['card']} ({ctx['smi']}): llama_1b, {L} layers, save_attn, B8 "
          f"S2048, GpuTrainer(num_workers=1, use_gpu) whose TrainWorker is a process of its "
          f"own, {RUNTIME_WARMUP} + {RUNTIME_STEPS} steps, fit in {fit_s:.3f} s: losses "
          f"bit-equal to the runtime phase's direct run {bit_equal}; median {step_ms:.3f} ms a "
          f"step (step and loss read) beside direct {direct['median_ms']:.3f} and the "
          f"in-process trainer {direct['median_trainer_ms']:.3f}; launches {launches} "
          f"({L} of each a step); train worker peak max_memory_allocated "
          f"{history[-1]['peak_bytes'] / 2**30:.3f} GiB", flush=True)
    require(bit_equal, f"cluster (e): losses {losses} differ from direct {direct['losses']}")
    out["e"] = {"fit_s": fit_s, "losses": losses, "bit_equal": bit_equal,
                "median_step_ms": step_ms, "launches": launches,
                "worker_peak_bytes": history[-1]["peak_bytes"]}
    return launches


def phase_cluster(ctx):
    """The port's cluster runtime on the card: (a) a Cluster whose head
    counts the card itself, with the native arena; (b) GPU and CPU worker
    processes and a CUDA tensor through the store; (c) a SPREAD GPU task
    placed by an external policy; (d) llama_1b served from a replica
    process; (e) llama_1b trained in a TrainWorker process."""
    import gc
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.rpc import SyncRpcClient

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if rt.is_initialized():
        rt.shutdown()
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    t0 = time.perf_counter()
    c = Cluster(initialize_head=False)
    gcs_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        head = c.add_node(is_head=True, num_cpus=8)
        agent_s = time.perf_counter() - t0
        rt.init(address=c.gcs_address)
        res = rt.cluster_resources()
        agent = SyncRpcClient(head.address)
        try:
            store = agent.call("node_info")["store"]
        finally:
            agent.close()

        @rt.remote
        def first():
            return os.getpid()

        t0 = time.perf_counter()
        rt.get(first.remote(), timeout=300)
        worker_s = time.perf_counter() - t0
        labels = rt.nodes()[0]["Labels"]
        print(f"cluster (a) on {ctx['card']} ({ctx['smi']}): GCS up in {gcs_s:.3f} s, head "
              f"agent in {agent_s:.3f} s, first worker's task in {worker_s:.3f} s; the agent "
              f"counted GPU {res.get('GPU')} (torch.cuda.device_count() "
              f"{torch.cuda.device_count()}), labels {labels}; object store backend "
              f"{store.get('backend')}", flush=True)
        require(res.get("GPU") == torch.cuda.device_count(),
                f"cluster (a): the agent counted {res.get('GPU')} GPUs, torch "
                f"{torch.cuda.device_count()}")
        require(store.get("backend") == "arena",
                f"cluster (a): the native arena is not live: {store}")
        out["a"] = {"gcs_s": gcs_s, "agent_s": agent_s, "first_worker_s": worker_s,
                    "GPU": res.get("GPU"), "labels": labels, "backend": store.get("backend")}
        _cluster_workers(ctx, rt, torch, out)
        gc.collect()
        torch.cuda.empty_cache()
        rt.shutdown()
        _cluster_policy(ctx, rt, Cluster, out)
        rt.init(address=c.gcs_address)
        ctx["cluster_serve_launches"] = _cluster_serve(ctx, rt, out)
        ctx["cluster_train_launches"] = _cluster_train(ctx, rt, tmp, out)
    finally:
        if rt.is_initialized():
            rt.shutdown()
        c.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    out["driver_peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"cluster on {ctx['card']} ({ctx['smi']}): the driver's peak max_memory_allocated "
          f"in this phase {out['driver_peak_bytes'] / 2**30:.3f} GiB", flush=True)
    ctx["cluster"] = out


# --------------------------------------------------------------------------- #
# cluster_apps: Serve's RPC ingress on per-node proxies, a compiled DAG
# --------------------------------------------------------------------------- #
# the device the replica and the learner compute on, and the learner's model
# and batch: the serve_app and runtime phases' (a CPU rehearsal swaps them)
APPS_DEVICE = "cuda"
APPS_TRAIN = dict(model="llama_1b", batch=8, seq=2048, attention_impl="flash")
APPS_LEARNER = "cluster_apps_learner"


def _apps_maker_class():
    """(c)'s CPU stage: the runtime phase's token batch from seed 0, as
    numpy (its data: ``rng.integers(0, vocab, (B, S))`` with rng seed 0, the
    same batch every step). Defined in a function: sent by value."""
    class Maker:
        def __init__(self, vocab_size, batch, seq):
            import numpy as np

            self.tokens = np.random.default_rng(0).integers(0, vocab_size, (batch, seq))

        def make(self, step):
            return self.tokens

    return Maker


def _apps_learner_class():
    """(c)'s GPU stage: one step of the runtime phase's llama_1b loop a call
    (save_attn, default_optimizer, weights from seed 0), returning the loss,
    the step's ms and launches, and a small bf16 slice of a parameter after
    the update (a CUDA tensor, through the channel)."""
    class Learner:
        def __init__(self, model, attention_impl, device):
            from ray_tpu_torch.models.llama import LlamaConfig
            from ray_tpu_torch.train.step import (default_optimizer,
                                                  make_train_state_factory, make_train_step)

            self.device = device
            cfg = getattr(LlamaConfig, model)(max_seq_len=2048, remat="save_attn",
                                              attention_impl=attention_impl)
            opt = default_optimizer(warmup_steps=10, total_steps=1000)
            self.state = make_train_state_factory(cfg, opt)(seed=0, device=device)
            self.step_fn = make_train_step(cfg, opt)

        def param_slice(self):
            return self.state.params["layers"]["wq"][0, :16, :16].detach().clone()

        def step(self, tokens_np):
            import torch

            from ray_tpu_torch import _kernels

            tokens = torch.from_numpy(tokens_np.copy()).to(self.device)
            targets = torch.roll(tokens, -1, dims=1)
            before = dict(_kernels.launch_counts)
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, tokens, targets)
            loss = metrics["loss"].item()  # waits for the step
            ms = (time.perf_counter() - t0) * 1e3
            return {"loss": loss, "ms": ms, "slice": self.param_slice(),
                    "launches": {n: c - before.get(n, 0)
                                 for n, c in _kernels.launch_counts.items()
                                 if c != before.get(n, 0)}}

        def process(self):
            import sys

            import torch

            from ray_tpu_torch.experimental import channel

            return {"pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "native_channel": channel._native_lib() is not None,
                    "peak_bytes": (torch.cuda.max_memory_allocated()
                                   if torch.cuda.is_available() else 0),
                    "jax_package": sorted({m.split(".")[0] for m in sys.modules}
                                          & {"ray_tpu", "jax"})}

    return Learner


def _apps_nodes(ctx, rt, out):
    """cluster_apps (a): both nodes through the state API."""
    from ray_tpu_torch.util import state

    nodes = [n for n in state.list_nodes() if n["Alive"]]
    summary = state.cluster_summary()
    gpus = {n["NodeID"][:8]: n["Resources"].get("GPU", 0.0) for n in nodes}
    head = rt.get_runtime_context().get_node_id()
    total = {}
    for n in nodes:
        for k, v in n["Resources"].items():
            total[k] = total.get(k, 0.0) + v
    print(f"cluster_apps (a): state.list_nodes() {len(nodes)} alive nodes, GPU by node {gpus} "
          f"(head {head[:8]}); cluster_summary nodes {summary['nodes']}, resources_total "
          f"{summary['resources_total']}", flush=True)
    require(len(nodes) == 2 and summary["nodes"] == 2,
            f"cluster_apps (a): expected 2 nodes, listed {len(nodes)}, summary {summary['nodes']}")
    require(all(n["Resources"].get("GPU", 0.0) == (1.0 if n["NodeID"] == head else 0.0)
                for n in nodes), f"cluster_apps (a): GPU by node {gpus}, head {head[:8]}")
    require(all(summary["resources_total"].get(k) == v for k, v in total.items()),
            f"cluster_apps (a): cluster_summary {summary['resources_total']} against the "
            f"nodes' {total}")
    out["a"] = {"gpu_by_node": gpus, "resources_total": summary["resources_total"]}
    return head, [n["NodeID"] for n in nodes if n["NodeID"] != head][0]


def _apps_serve(ctx, rt, torch, cpu_node, out):
    """cluster_apps (b): llama_1b behind one proxy per node, through HTTP on
    each, and through the CPU node's msgpack-RPC ingress: unary, streamed,
    and 64 requests at once."""
    import urllib.request

    from ray_tpu_torch import serve
    from ray_tpu_torch.util import state

    L = _llama_1b().num_layers
    pr = ctx["serve_app_prompts"]
    n_req, max_tokens = SERVE_APP_REQUESTS, SERVE_APP_TOKENS
    free0 = torch.cuda.mem_get_info()[0]
    t0 = time.perf_counter()
    serve.start(proxy_location="every_node", http_port=0)
    app = (serve.deployment(_cluster_llm_class(), name="llm")
           .options(ray_actor_options={"num_gpus": 1}, max_ongoing_requests=n_req)
           .bind(**dict(SERVE_APP_KW, device=APPS_DEVICE)))
    handle = serve.run(app, http=True, http_port=0, proxy_location="every_node")
    client = None
    try:
        deploy_s = time.perf_counter() - t0
        proxies = serve.api._state["proxies"]
        addrs = serve.http_addresses()
        rpc = rt.get([p.rpc_address.remote() for p in proxies], timeout=60)
        where = {a["actor_id"]: a.get("node_id") for a in state.list_actors()
                 if str(a.get("name", "")).startswith("SERVE_PROXY:")}
        cpu_rpc = [addr for p, addr in zip(proxies, rpc)
                   if where.get(p.actor_id.hex()) == cpu_node]
        require(len(proxies) == 2 and len(addrs) == 2 and len(cpu_rpc) == 1,
                f"cluster_apps (b): proxies {len(proxies)}, HTTP {addrs}, RPC {rpc}, the CPU "
                f"node's {cpu_rpc} (placed {where})")
        http = []
        for addr in addrs:
            for p in pr["singles"]:
                req = urllib.request.Request(
                    f"{addr}/llm", data=json.dumps({"tokens": p, "max_tokens": max_tokens,
                                                    "timeout": 600}).encode(),
                    headers={"Content-Type": "application/json"})
                http.append(json.loads(urllib.request.urlopen(req, timeout=600).read())["tokens"])
        client = serve.ServeRpcClient(cpu_rpc[0])
        unary = [client.call("llm", {"tokens": p, "max_tokens": max_tokens, "timeout": 600},
                             timeout=600)["tokens"] for p in pr["singles"]]
        streamed, n_items = [], 0
        for p in pr["singles"]:
            toks = []
            for item in client.stream("llm", {"tokens": p, "max_tokens": max_tokens,
                                              "timeout": 600, "stream": True},
                                      item_timeout=600):
                n_items += 1
                if "token" in item:
                    toks.append(item["token"])
            streamed.append(toks)
        want = pr["want"]
        print(f"cluster_apps (b) on {ctx['card']} ({ctx['smi']}): serve.start("
              f"proxy_location='every_node'), the replica ready in {deploy_s:.3f} s; proxies "
              f"HTTP {addrs}, RPC {rpc} (the CPU node's {cpu_rpc[0]}); serve_app's "
              f"{len(want)} prompts: HTTP on each proxy equal to the serve phase's tokens "
              f"{http == want * len(addrs)}, RPC unary {unary == want}, RPC streamed "
              f"({n_items} items) {streamed == want}", flush=True)
        require(http == want * len(addrs), "cluster_apps (b): HTTP tokens differ")
        require(unary == want, "cluster_apps (b): RPC unary tokens differ")
        require(streamed == want, "cluster_apps (b): RPC streamed tokens differ")
        s0 = handle.engine_stats.remote().result(timeout=60)
        handle.reset_counts.remote().result(timeout=60)
        results, ends, t0 = _run_load(lambda r: client.call("llm", r, timeout=600),
                                      pr["prompts"], max_tokens)
        counts = handle.launch_counts.remote().result(timeout=60)
        s1 = handle.engine_stats.remote().result(timeout=60)
        proc = handle.process.remote().result(timeout=60)
    finally:
        if client is not None:
            client.close()
        serve.shutdown()
    fig = _load_figures(results, ends, t0)
    for r in results:
        require(len(r["tokens"]) == max_tokens,
                f"cluster_apps (b): a request returned {len(r['tokens'])} tokens")
    programs = s1["prefill_programs"] - s0["prefill_programs"]
    ticks = s1["decode_steps"] - s0["decode_steps"]
    require_no_plain(counts, "cluster_apps (b)")
    require(counts.get("flash_fwd") == L * programs and counts.get("paged_attention") == L * ticks
            and programs > 0 and ticks > 0,
            f"cluster_apps (b): the replica launched {counts} against {programs} prefill "
            f"programs and {ticks} decode ticks of {L} layers")
    require(proc["pid"] != os.getpid() and not proc["jax_package"],
            f"cluster_apps (b): the replica's process {proc}")
    launches = {n: counts.get(n, 0) for n in ("flash_fwd", "paged_attention")}
    # serve.shutdown() frees the card: the replica's process lets its memory go
    deadline = time.monotonic() + 60
    while True:
        free1 = torch.cuda.mem_get_info()[0]
        freed = free1 >= free0 - (1 << 30)
        if freed or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    cd = ctx["cluster"]["d"]["serve"]
    print(f"cluster_apps (b) on {ctx['card']} ({ctx['smi']}): {n_req} requests at once through "
          f"the CPU node's RPC ingress: {_fmt_load(fig)}; the replica's launches {launches} "
          f"({programs} prefill programs, {ticks} decode ticks), plain 0; beside the cluster "
          f"phase's (d) through the handle {cd['req_per_s']:.3f} req/s, latency p50 "
          f"{cd['p50_latency_s'] * 1e3:.1f} ms p99 {cd['p99_latency_s'] * 1e3:.1f} ms; after "
          f"serve.shutdown() the card's free memory {free1 / 2**30:.3f} GiB against "
          f"{free0 / 2**30:.3f} before the deployment", flush=True)
    require(freed, f"cluster_apps (b): serve.shutdown() left the card at {free1} free "
            f"bytes, {free0} before")
    out["b"] = {"deploy_s": deploy_s, "rpc": fig, "launches": launches,
                "prefill_programs": programs, "decode_ticks": ticks,
                "replica_peak_bytes": proc["peak_bytes"], "free_before": free0,
                "free_after_shutdown": free1}
    return launches


def _apps_dag(ctx, rt, torch, head, out):
    """cluster_apps (c): the runtime phase's llama_1b step as the GPU stage of
    a compiled DAG fed by a CPU stage over a shared-memory channel."""
    from ray_tpu_torch.core.resources import NodeAffinitySchedulingStrategy
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.models.llama import LlamaConfig

    cfg = getattr(LlamaConfig, APPS_TRAIN["model"])()
    L = cfg.num_layers
    want = {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    n = RUNTIME_WARMUP + RUNTIME_STEPS
    Maker = rt.remote(_apps_maker_class()).options(
        scheduling_strategy=NodeAffinitySchedulingStrategy(head))
    Learner = rt.remote(_apps_learner_class()).options(num_gpus=1, name=APPS_LEARNER)
    maker = Maker.bind(cfg.vocab_size, APPS_TRAIN["batch"], APPS_TRAIN["seq"])
    learner = Learner.bind(APPS_TRAIN["model"], APPS_TRAIN["attention_impl"], APPS_DEVICE)
    with InputNode() as step:
        loss = learner.step.bind(maker.make.bind(step))
    t0 = time.perf_counter()
    compiled = loss.experimental_compile()
    compile_s = time.perf_counter() - t0
    records, walls = [], []
    try:
        native_driver = compiled._input_chan._lib is not None
        for i in range(n):
            t0 = time.perf_counter()
            records.append(compiled.execute(i).get(timeout=600))
            walls.append((time.perf_counter() - t0) * 1e3)
    finally:
        compiled.teardown()
    # after teardown the learner takes normal calls again
    handle = rt.get_actor(APPS_LEARNER)
    after = rt.get(handle.param_slice.remote(), timeout=120)
    proc = rt.get(handle.process.remote(), timeout=120)
    rt.kill(handle)
    losses = [r["loss"] for r in records]
    direct = ctx["runtime_direct"]
    bit_equal = losses == direct["losses"]
    last = records[-1]["slice"]
    slice_equal = (last.device.type == after.device.type == APPS_DEVICE
                   and last.dtype == after.dtype == torch.bfloat16
                   and torch.equal(last.view(torch.int16), after.view(torch.int16)))
    step_ms = statistics.median(r["ms"] for r in records[RUNTIME_WARMUP:])
    wall_ms = statistics.median(walls[RUNTIME_WARMUP:])
    launches = {k: v * n for k, v in want.items()}
    print(f"cluster_apps (c) on {ctx['card']} ({ctx['smi']}): with InputNode() as step: "
          f"learner.step.bind(maker.make.bind(step)), compiled in {compile_s:.3f} s; "
          f"{RUNTIME_WARMUP} + {RUNTIME_STEPS} execute(i): losses bit-equal to the runtime "
          f"phase's direct run {bit_equal}; median {step_ms:.3f} ms a step in the learner, "
          f"{wall_ms:.3f} ms execute to get in the driver, beside direct "
          f"{direct['median_ms']:.3f}; launches a step {[r['launches'] for r in records[:1]]}; "
          f"the slice through the channel on {last.device}, bit-equal to the learner's after "
          f"teardown {slice_equal}; native channel ops: driver {native_driver}, learner "
          f"{proc['native_channel']}; learner peak max_memory_allocated "
          f"{proc['peak_bytes'] / 2**30:.3f} GiB", flush=True)
    for r in records:
        require(r["launches"] == want, f"cluster_apps (c): a step launched {r['launches']}, "
                f"expected {want} and no other kernel")
    require(bit_equal, f"cluster_apps (c): losses {losses} differ from direct "
            f"{direct['losses']}")
    require(slice_equal, "cluster_apps (c): the parameter slice through the channel "
            f"({last.device}, {last.dtype}) is not the learner's ({after.device})")
    require(native_driver and proc["native_channel"],
            "cluster_apps (c): the channel did not use the native ops")
    require(proc["pid"] != os.getpid() and not proc["jax_package"],
            f"cluster_apps (c): the learner's process {proc}")
    out["c"] = {"compile_s": compile_s, "losses": losses, "bit_equal": bit_equal,
                "median_step_ms": step_ms, "median_execute_ms": wall_ms,
                "launches": launches, "learner_peak_bytes": proc["peak_bytes"]}
    return launches


def phase_cluster_apps(ctx):
    """Serve's RPC ingress on per-node proxies and a compiled DAG on the
    port's cluster: (a) a head with the card and a CPU-only node, listed
    through the state API; (b) llama_1b behind one proxy per node, through
    HTTP, the CPU node's RPC ingress unary and streamed, and 64 requests at
    once; (c) the llama_1b train step as the GPU stage of a compiled DAG;
    (d) the object-transfer probe."""
    import gc

    import torch

    import ray_tpu_torch as rt
    from ray_tpu_torch.bench import measure_object_transfer
    from ray_tpu_torch.cluster import Cluster

    gc.collect()
    torch.cuda.empty_cache()
    if rt.is_initialized():
        rt.shutdown()
    out = {}
    c = Cluster(initialize_head=False)
    try:
        c.add_node(is_head=True, num_cpus=8)
        # a CPU-only node: its agent sees no card (num_gpus=0 lets an agent
        # count the cards it sees)
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            c.add_node(num_cpus=4, num_gpus=0)
        finally:
            if visible is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = visible
        c.wait_for_nodes(2, timeout=60)
        rt.init(address=c.gcs_address)
        head, cpu_node = _apps_nodes(ctx, rt, out)
        ctx["cluster_apps_serve_launches"] = _apps_serve(ctx, rt, torch, cpu_node, out)
        ctx["cluster_apps_train_launches"] = _apps_dag(ctx, rt, torch, head, out)
    finally:
        if rt.is_initialized():
            rt.shutdown()
        c.shutdown()
    probe = measure_object_transfer()
    print(f"cluster_apps (d): ray_tpu_torch.bench.measure_object_transfer(): "
          f"{probe['bytes'] >> 20} MB pulled by the second agent at {probe['pull_mbps']} MB/s, "
          f"raw_transfer {probe['raw_transfer']}", flush=True)
    require(probe["raw_transfer"] is True, f"cluster_apps (d): {probe}")
    out["d"] = probe
    ctx["cluster_apps"] = out


# --------------------------------------------------------------------------- #
# ops_shell: the operator's entry points (CLI, job submission, autoscaler)
# --------------------------------------------------------------------------- #
# the autoscaler's GPU node: idle this long before it is terminated; the
# phase allows 20 s more for the termination itself
OPS_IDLE_TIMEOUT_S = 10.0
# the GPU node must be alive, and the actor placed, within this (no fallback
# to the CPU: the job fails instead)
OPS_NODE_TIMEOUT_S = 120.0
# (c)2: llama_1b train steps in the actor
OPS_TRAIN_STEPS = 3
# the job's lines the phase reads from the log the CLI streams
OPS_FIRST_LINE, OPS_RESULT_LINE = "OPS_SHELL_FIRST_RESULT", "OPS_SHELL_RESULT "
OPS_JOB_SCRIPT = '''import sys

import chip_smoke  # the repo, the job's working dir, is on PYTHONPATH

sys.exit(chip_smoke.ops_shell_job(sys.argv[1]))
'''


class OpsShellActor:
    """(c)'s num_gpus=1 actor: it runs in the GPU worker of the node the
    autoscaler launched. Sent by reference: the worker imports chip_smoke
    from the repo on its PYTHONPATH."""

    def where(self):
        import sys

        import torch

        import ray_tpu_torch as rt

        return {"pid": os.getpid(), "node_id": rt.get_runtime_context().get_node_id(),
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "card": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None,
                "jax_package": sorted({m.split(".")[0] for m in sys.modules}
                                      & {"ray_tpu", "jax"})}

    def serve(self, spec):
        """(c)1: the serve phase's engine at llama_1b's width (``layers``
        deep, seed-0 weights), its warm-up, then the prompts one at a time;
        the engine is freed before returning."""
        import dataclasses
        import gc

        import torch

        from ray_tpu_torch import _kernels
        from ray_tpu_torch.models.llama import llama_init
        from ray_tpu_torch.serve.llm import LLMEngine

        cfg = dataclasses.replace(_llama_1b(), num_layers=spec["layers"])
        engine = LLMEngine(cfg, llama_init(cfg, seed=0, device="cuda"), device="cuda",
                           **SERVE_ENGINE_KW)
        try:
            engine.generate(spec["prompts"][0], max_tokens=4, timeout=600)
            torch.cuda.synchronize()
            s0 = engine.stats()
            _kernels.reset_counts()
            tokens = [engine.generate(p, spec["max_tokens"], None, 600)["tokens"]
                      for p in spec["prompts"]]
            s1 = engine.stats()
            counts = dict(_kernels.launch_counts)
        finally:
            engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        return {"tokens": tokens, "launches": counts,
                "prefill_programs": s1["prefill_programs"] - s0["prefill_programs"],
                "decode_ticks": s1["decode_steps"] - s0["decode_steps"],
                "peak_bytes": torch.cuda.max_memory_allocated()}

    def train(self, spec):
        """(c)2: the runtime phase's llama_1b loop (B8 S2048, seed 0),
        ``OPS_TRAIN_STEPS`` steps; the state stays here for round_trip."""
        import torch

        history = []
        self.state = _runtime_llama_loop(history.append, steps=OPS_TRAIN_STEPS,
                                         layers=spec["layers"])
        return {"losses": [r["loss"] for r in history], "ms": [r["ms"] for r in history],
                "launches": [r["launches"] for r in history],
                "peak_bytes": torch.cuda.max_memory_allocated()}

    def round_trip(self):
        """(c)3: the trained parameters and AdamW moments through
        params_to_jax and back; every leaf's bits compared. Without
        ml_dtypes, that params_to_jax raises the ImportError naming it."""
        import torch

        from ray_tpu_torch.models.llama import params_from_jax, params_to_jax

        try:
            import ml_dtypes
        except ImportError:
            try:
                params_to_jax(self.state.params)
            except ImportError as e:
                return {"ml_dtypes": None, "error": str(e)}
            return {"ml_dtypes": None, "error": None}
        trees = {"params": self.state.params, "mu": self.state.opt_state.mu,
                 "nu": self.state.opt_state.nu}
        out = {"ml_dtypes": ml_dtypes.__version__, "leaves": 0, "differ": [], "dtypes": {}}
        for name, tree in trees.items():
            back = params_from_jax(params_to_jax(tree), device="cuda")
            for path, a, b in _leaf_pairs(name, tree, back):
                bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
                out["leaves"] += 1
                out["dtypes"][str(a.dtype)] = out["dtypes"].get(str(a.dtype), 0) + 1
                if (a.dtype != b.dtype or a.device != b.device
                        or not torch.equal(a.detach().view(bits), b.view(bits))):
                    out["differ"].append(path)
            del back
        return out


def _leaf_pairs(prefix, a, b):
    if isinstance(a, dict):
        for k in sorted(a):
            yield from _leaf_pairs(f"{prefix}/{k}", a[k], b[k])
    else:
        yield prefix, a, b


def ops_shell_job(spec_path: str) -> int:
    """The job's driver (OPS_JOB_SCRIPT): ``ray_tpu_torch.init()`` from
    RAY_TPU_ADDRESS, one num_gpus=1 OpsShellActor, its three steps; prints
    the actor's figures as one JSON line."""
    import ray_tpu_torch as rt

    with open(spec_path) as f:
        spec = json.load(f)
    rt.init()
    actor = rt.remote(num_gpus=1)(OpsShellActor).remote()
    try:
        where = rt.get(actor.where.remote(), timeout=OPS_NODE_TIMEOUT_S)
        serve = rt.get(actor.serve.remote(spec), timeout=900)
        print(OPS_FIRST_LINE, flush=True)
        train = rt.get(actor.train.remote(spec), timeout=900)
        round_trip = rt.get(actor.round_trip.remote(), timeout=600)
        print(OPS_RESULT_LINE + json.dumps({"where": where, "serve": serve, "train": train,
                                            "round_trip": round_trip}), flush=True)
    finally:
        rt.kill(actor)
        rt.shutdown()
    return 0


def _pgroup_members(pgids):
    """Live (non-zombie) processes whose process group is one of ``pgids``."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[2]) in pgids:
            out.append(int(entry))
    return out


def _rtpt_files():
    return {n for n in os.listdir("/dev/shm") if n.startswith("rtpt-")}


def ops_shell_run(card: str, layers: int, want_tokens, want_losses, prompts,
                  max_tokens: int = 64):
    """(a)-(e) of the ops_shell phase, at llama_1b's width with ``layers``
    layers; ``want_tokens`` (of ``prompts``, one at a time) and
    ``want_losses`` are the references. Returns the phase's figures and the
    actor's launches, (c)1's and (c)2's."""
    import shutil
    import tempfile
    import threading

    import torch

    from ray_tpu_torch.autoscaler import (AutoscalerConfig, LocalNodeProvider,
                                          StandardAutoscaler)
    from ray_tpu_torch.core.rpc import SyncRpcClient

    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ops_shell_")
    # the CLI's session file and dir, and the job's files, are the phase's own
    env = dict(os.environ, HOME=tmp)

    def cli(*args, **kw):
        return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args], env=kw.pop(
            "env", env), cwd=repo, capture_output=True, text=True, timeout=120, **kw)

    free0 = torch.cuda.mem_get_info()[0]
    shm0 = _rtpt_files()
    out = {}
    scaler = provider = gcs = None
    session = {}
    try:
        # (a) the head, without the card
        t0 = time.perf_counter()
        r = cli("start", "--head", "--num-cpus", "4", "--session-dir",
                os.path.join(tmp, "session"), env=dict(env, CUDA_VISIBLE_DEVICES=""))
        require(r.returncode == 0, f"ops_shell (a): start failed: {r.stdout}{r.stderr}")
        start_s = time.perf_counter() - t0
        with open(os.path.join(tmp, ".ray_tpu_torch", "session")) as f:
            session = json.load(f)
        address = session["gcs_address"]
        r = cli("status", "--address", address)
        require(r.returncode == 0 and "nodes alive:     1" in r.stdout and "GPU" not in r.stdout,
                f"ops_shell (a): status {r.stdout}{r.stderr}")
        print(f"ops_shell (a): `python -m ray_tpu_torch start --head --num-cpus 4` under "
              f'CUDA_VISIBLE_DEVICES="" in {start_s:.3f} s (session file under the temp HOME, '
              f"GCS {address}); status: 1 node alive, no GPU", flush=True)
        out["a"] = {"start_s": start_s}
        # (b) the autoscaler, in this process
        gcs = SyncRpcClient(address)
        head_id = [n["NodeID"] for n in gcs.call("get_nodes") if n["Alive"]][0]
        provider = LocalNodeProvider(address)
        scaler = StandardAutoscaler(address, provider, AutoscalerConfig(
            worker_node_config={"num_cpus": 2, "num_gpus": 1}, max_workers=1,
            idle_timeout_s=OPS_IDLE_TIMEOUT_S))
        scaler.start()
        # (c) the job, through the CLI, its log streamed until it ends
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump({"layers": layers, "prompts": prompts, "max_tokens": max_tokens}, f)
        job_path = os.path.join(tmp, "llama_job.py")
        with open(job_path, "w") as f:
            f.write(OPS_JOB_SCRIPT)
        stamps = {}
        lines = []
        t_submit = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch", "submit", "--address", address,
             "--working-dir", repo, "--", sys.executable, job_path, spec_path],
            env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def watch_nodes():
            client = SyncRpcClient(address)
            try:
                while proc.poll() is None and "node" not in stamps:
                    if len([n for n in client.call("get_nodes") if n["Alive"]]) >= 2:
                        stamps["node"] = time.perf_counter()
                    time.sleep(0.1)
            finally:
                client.close()

        watcher = threading.Thread(target=watch_nodes, daemon=True)
        watcher.start()
        killer = threading.Timer(1800, proc.kill)
        killer.start()
        try:
            for line in proc.stdout:
                lines.append(line)
                if line.startswith(OPS_FIRST_LINE):
                    stamps["first"] = time.perf_counter()
            rc = proc.wait()
        finally:
            killer.cancel()
        t_end = time.perf_counter()
        watcher.join(timeout=5)
        log = "".join(lines)
        with open(os.path.join(tmp, "submit.log"), "w") as f:
            f.write(log)
        require(rc == 0 and "SUCCEEDED" in log,
                f"ops_shell (c): submit exited {rc}; its output ends:\n{log[-4000:]}")
        job_id = lines[0].split()[1].rstrip(":")
        result = json.loads([ln for ln in lines if ln.startswith(OPS_RESULT_LINE)][-1]
                            [len(OPS_RESULT_LINE):])
        require("node" in stamps and "first" in stamps,
                f"ops_shell (c): the node {'node' in stamps}, the first result "
                f"{'first' in stamps}")
        node_s, first_s, job_s = (stamps["node"] - t_submit, stamps["first"] - t_submit,
                                  t_end - t_submit)
        # (c) on the autoscaled node's GPU worker
        where = result["where"]
        handles = provider.non_terminated_nodes()
        scaled = {n["NodeManagerAddress"]: n["NodeID"] for n in gcs.call("get_nodes")}
        node_ids = {scaled.get(provider.node_address_of(h)) for h in handles}
        require(scaler.launched == 1 and where["node_id"] in node_ids
                and where["node_id"] != head_id and where["visible"] == "0"
                and where["card"] == card and not where["jax_package"],
                f"ops_shell (c): the actor ran at {where}; the autoscaler launched "
                f"{scaler.launched} node(s) {node_ids}, the head {head_id[:8]}")
        print(f"ops_shell (c) on {card}: `submit --working-dir {repo} -- python llama_job.py` "
              f"({job_id}); the autoscaler launched 1 node (num_cpus 2, num_gpus 1), alive "
              f"{node_s:.3f} s after submit; the num_gpus=1 actor ran in its GPU worker (pid "
              f"{where['pid']}, CUDA_VISIBLE_DEVICES={where['visible']}, no JAX package)",
              flush=True)
        L = layers
        sv = result["serve"]
        programs, ticks, counts = sv["prefill_programs"], sv["decode_ticks"], sv["launches"]
        require_no_plain(counts, "ops_shell (c)1")
        require(counts.get("flash_fwd") == L * programs and counts.get("paged_attention")
                == L * ticks and programs > 0 and ticks > 0,
                f"ops_shell (c)1: launched {counts} against {programs} prefill programs and "
                f"{ticks} decode ticks of {L} layers")
        serve_launches = {n: counts.get(n, 0) for n in ("flash_fwd", "paged_attention")}
        same = sv["tokens"] == want_tokens
        print(f"ops_shell (c)1: {len(prompts)} prompts one at a time through LLMEngine "
              f"({L} layers, the serve phase's settings), tokens equal to the reference "
              f"{same}; launches {serve_launches} ({programs} prefill programs, {ticks} "
              f"decode ticks), plain 0; peak {sv['peak_bytes'] / 2**30:.3f} GiB", flush=True)
        require(same, f"ops_shell (c)1: tokens {[t[:8] for t in sv['tokens']]} against "
                f"{[t[:8] for t in want_tokens]}")
        tr = result["train"]
        want = {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
        for i, got in enumerate(tr["launches"]):
            require(got == want, f"ops_shell (c)2 step {i} launched {got}, expected {want} "
                    "and no other kernel")
        bit_equal = tr["losses"] == want_losses
        train_launches = {k: v * len(tr["launches"]) for k, v in want.items()}
        print(f"ops_shell (c)2: {len(tr['losses'])} llama_1b steps ({L} layers, B8 S2048, "
              f"seed 0) in the actor: losses {tr['losses']} bit-equal to the reference "
              f"{bit_equal}; ms {[round(m, 3) for m in tr['ms']]}; launches {train_launches}, "
              f"plain 0; peak {tr['peak_bytes'] / 2**30:.3f} GiB", flush=True)
        require(bit_equal, f"ops_shell (c)2: losses {tr['losses']} against {want_losses}")
        rtrip = result["round_trip"]
        if rtrip["ml_dtypes"] is None:
            require(rtrip["error"] and "ml_dtypes" in rtrip["error"],
                    f"ops_shell (c)3: without ml_dtypes params_to_jax gave {rtrip}")
            print("ops_shell (c)3: the card machine has no ml_dtypes; params_to_jax raised "
                  f"ImportError ({rtrip['error']}); the bf16 round trip is held on the CPU only "
                  "(tests/test_torch_convert.py)", flush=True)
        else:
            require(rtrip["leaves"] > 0 and not rtrip["differ"],
                    f"ops_shell (c)3: leaves that differ after the round trip: {rtrip}")
            print(f"ops_shell (c)3: ml_dtypes {rtrip['ml_dtypes']}; params, mu and nu through "
                  f"params_to_jax and params_from_jax: {rtrip['leaves']} leaves "
                  f"{rtrip['dtypes']}, every one bit-equal on cuda", flush=True)
        # (d) the job's record
        r = cli("list", "jobs", "--address", address)
        jobs = {j["job_id"]: j for j in json.loads(r.stdout)} if r.returncode == 0 else {}
        job = jobs.get(job_id, {})
        r = cli("logs", job_id, "--address", address)
        require(job.get("status") == "SUCCEEDED" and job.get("returncode") == 0
                and OPS_RESULT_LINE in r.stdout,
                f"ops_shell (d): list jobs {job}; logs hold the result line "
                f"{OPS_RESULT_LINE in r.stdout}")
        print(f"ops_shell (d): `list jobs`: {job_id} SUCCEEDED, return code 0; `logs` holds "
              f"the JSON line; submit to the node alive {node_s:.3f} s, to the first result "
              f"{first_s:.3f} s, the job {job_s:.3f} s", flush=True)
        # (e) scale-down, the card's memory, stop
        require(_until(lambda: scaler.terminated >= 1, OPS_IDLE_TIMEOUT_S + 20),
                f"ops_shell (e): the idle GPU node was not terminated within "
                f"{OPS_IDLE_TIMEOUT_S + 20:.0f} s of the job's end")
        down_s = time.perf_counter() - t_end
        require(_until(lambda: torch.cuda.mem_get_info()[0] >= free0 - 2**30, 10),
                f"ops_shell (e): free memory {torch.cuda.mem_get_info()[0] / 2**30:.3f} GiB "
                f"against {free0 / 2**30:.3f} before (a)")
        free1 = torch.cuda.mem_get_info()[0]
        out.update(c={"job_id": job_id, "node_s": node_s, "first_result_s": first_s,
                      "job_s": job_s, "tokens_equal": same, "losses": tr["losses"],
                      "losses_bit_equal": bit_equal, "train_ms": tr["ms"],
                      "serve_launches": serve_launches, "train_launches": train_launches,
                      "prefill_programs": programs, "decode_ticks": ticks,
                      "serve_peak_bytes": sv["peak_bytes"], "train_peak_bytes": tr["peak_bytes"],
                      "round_trip": rtrip},
                   e={"scale_down_s": down_s, "free_before_gib": free0 / 2**30,
                      "free_after_gib": free1 / 2**30})
    finally:
        if scaler is not None:
            scaler.stop()
            for h in provider.non_terminated_nodes():
                provider.terminate_node(h)
        if gcs is not None:
            gcs.close()
        r = cli("stop")
        pgids = set(session.get("pids", []))
        shutil.rmtree(tmp, ignore_errors=True)
        if provider is not None:
            shutil.rmtree(provider.session_dir, ignore_errors=True)
    require(r.returncode == 0, f"ops_shell (e): stop failed: {r.stdout}{r.stderr}")
    _until(lambda: not _pgroup_members(pgids), 10)
    left = _pgroup_members(pgids)
    files = _rtpt_files() - shm0
    print(f"ops_shell (e): the autoscaler terminated the idle GPU node {out['e']['scale_down_s']:.3f}"
          f" s after the job ended (idle timeout {OPS_IDLE_TIMEOUT_S:.0f} s); free memory "
          f"{out['e']['free_after_gib']:.3f} GiB against {out['e']['free_before_gib']:.3f} before "
          f"(a); `stop` left {len(left)} processes of the session and {len(files)} rtpt- files",
          flush=True)
    require(not left, f"ops_shell (e): processes of the session still alive: {left}")
    require(not files, f"ops_shell (e): /dev/shm files left: {sorted(files)}")
    return out, out["c"]["serve_launches"], out["c"]["train_launches"]


def _until(cond, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.1)
    return cond()


def phase_ops_shell(ctx):
    """The slice through the operator's entry points, at llama_1b's full
    width: (a) `python -m ray_tpu_torch start` of a head without the card;
    (b) a StandardAutoscaler of GPU nodes in this process; (c) a job
    submitted through the CLI whose num_gpus=1 actor serves and trains
    llama_1b on the node the autoscaler launched; (d) the job's record;
    (e) scale-down, the card's memory, `stop`."""
    import gc

    import torch

    import ray_tpu_torch as rt

    gc.collect()
    torch.cuda.empty_cache()
    if rt.is_initialized():
        rt.shutdown()
    singles = ctx["serve_singles"]
    out, serve_launches, train_launches = ops_shell_run(
        ctx["card"], _llama_1b().num_layers, singles["tokens"],
        ctx["runtime_direct"]["losses"][:OPS_TRAIN_STEPS], singles["prompts"])
    ctx["ops_shell"] = out
    ctx["ops_shell_serve_launches"] = serve_launches
    ctx["ops_shell_train_launches"] = train_launches


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
            "k3": ctx["train_launches"], "k4": ctx["launches"],
            # the CUDA-core kernels, from the c5 phase's fp32 and D256 engines
            # and its fp32 train steps
            "k1s": ctx["c5_serve_launches"], "k1ls": ctx["c5_train_launches"],
            "k2s": ctx["c5_train_launches"], "k3s": ctx["c5_train_launches"],
            "k4s": ctx["c5_serve_launches"]}
    kernels = []
    for key, run in runs.items():
        entry = dict(ctx[key], launches=run.get(ctx[key]["name"], 0))
        if key in ("k1l", "k2", "k3"):  # the same kernels in the vit phase's 10 timed steps
            entry["launches_vit"] = ctx["vit_launches"].get(entry["name"], 0)
            # and in the mesh phase's timed steps (sharded and unsharded in turns)
            entry["launches_mesh"] = ctx["mesh_launches"].get(entry["name"], 0)
            # and in the runtime phase's first GpuTrainer run (8 llama_1b steps)
            entry["launches_runtime"] = ctx["runtime_launches"].get(entry["name"], 0)
            # and in the data phase's 21 ViT-L steps fed by iter_torch_batches
            entry["launches_data"] = ctx["data_launches"].get(entry["name"], 0)
            # and in the cluster phase's TrainWorker process (8 llama_1b steps)
            entry["launches_cluster"] = ctx["cluster_train_launches"].get(entry["name"], 0)
            # and in the cluster_apps phase's compiled-DAG learner (8 steps)
            entry["launches_cluster_apps"] = ctx["cluster_apps_train_launches"].get(
                entry["name"], 0)
            # and in the ops_shell phase's actor on the autoscaled node (3 steps)
            entry["launches_ops_shell"] = ctx["ops_shell_train_launches"].get(entry["name"], 0)
        elif key in ("k1", "k4"):  # in the serve_app phase's 64 requests through serve
            entry["launches_serve_app"] = ctx["serve_app_launches"].get(entry["name"], 0)
            # and in the c5 phase's bf16 engines (groups 1 and 8; K4 also at D256)
            entry["launches_c5"] = ctx["c5_bf16_launches"].get(entry["name"], 0)
            # and in the cluster phase's replica process (64 requests)
            entry["launches_cluster"] = ctx["cluster_serve_launches"].get(entry["name"], 0)
            # and in the cluster_apps phase's replica behind the RPC ingress
            entry["launches_cluster_apps"] = ctx["cluster_apps_serve_launches"].get(
                entry["name"], 0)
            # and in the ops_shell phase's actor on the autoscaled node (4 prompts)
            entry["launches_ops_shell"] = ctx["ops_shell_serve_launches"].get(entry["name"], 0)
        kernels.append(entry)
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        print(f"chip_smoke: kernels never launched on the main path: {idle}", file=sys.stderr)
        return 1
    record = {"card": ctx["card"], "smi": ctx["smi"], "build_s": ctx["build_s"],
              "peaks": ctx["peaks_key"], "kernels": kernels,
              "model_rel_err": ctx["model_rel_err"], "serve": ctx["serve"],
              "train": ctx["train"], "rl": ctx["rl"], "vit": ctx["vit"], "mesh": ctx["mesh"],
              "runtime": ctx["runtime"], "serve_app": ctx["serve_app"],
              "rl_platform": ctx["rl_platform"], "c5": ctx["c5"],
              "data": {k: v for k, v in ctx["data"].items() if k != "per_op_stats"},
              "data_per_op_stats": ctx["data"].get("per_op_stats"), "cluster": ctx["cluster"],
              "cluster_apps": ctx["cluster_apps"], "ops_shell": ctx["ops_shell"]}
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
