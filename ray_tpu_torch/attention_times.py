"""Times of the attention kernels on one card (K1', the forward with lse;
K2, dQ; K3, dK/dV; K4, paged decode), for comparing two checkouts of this
repository in one run on one card.

    python3 ray_tpu_torch/attention_times.py [--paged] [CHECKOUT ...]

Each CHECKOUT is the root of a checkout (default: the one this file lies
in). Each is timed in a process of its own, in the order given, so
``OLD NEW NEW OLD`` compares two commits in turns. A process imports
``ray_tpu_torch`` from its checkout, builds that checkout's kernels there,
and calls only what every checkout since the flash backward (K2, K3) has:
``flash_attention``, ``flash_attention_lse``, ``_delta``, ``flash_bwd_dq``
and ``flash_bwd_dkv``.
The shapes are llama_1b's training attention (B8, S2048, 16 q heads over 4,
D128, causal), ViT-L/16's (B32, S196, 16 heads over 16, D64, not causal)
and llama_1b's width as 8 q heads of 256 over 2 at the training shape (B8
S2048, causal) and at the prefill of 8 prompts of 128 tokens (B8 S128),
where K1 (``flash_attention``) is timed too: a checkout that routes bf16
at D256 to the CUDA cores times those kernels there. In fp32, K1, K1', K2
and K3 are timed at the c5 engines' prefill (B8 S128, 16 q heads over 4,
D128, causal), the c5 train step's attention (B2 S512) and llama_1b's
training shape (B8 S2048): a checkout older than the 3xTF32 forward
(backward) runs it on the CUDA cores. The c5 fp32 train step (llama_1b's
width at 2 layers, fp32, ``save_attn``, B2 S512) is timed too: ms a step
over 5 steps after 2 warm-up steps. A shape a checkout's kernels refuse is
reported as null. K4 (``models.paged_decode.paged_attention``, in every
checkout) is timed at the serving table: 64 slots of 1..512 rows on 64-row
pages, a 32-page table, 16 q heads over 4 of D128, bf16; and in fp32 at the
c5 fp32 engine's decode (8 slots of 1..512 rows, an 8-page table) and at 4
slots of 1537..2048 rows (a 32-page table), where a checkout older than
the fp32 split decode runs its CUDA-core decode. Each line of output is one
checkout's JSON: ms a call (mean of 20 calls between CUDA events, inputs
cycling over copies larger than the L2), per kernel and shape; for K4 also
``device_ms`` (the same 20 calls captured in a CUDA graph and replayed: the
device alone) and ``host_us`` (host clock over 200 wrapper calls with no
synchronisation in between; ``ROUNDS`` rounds, each listed). ``--paged``
times K4 alone. Every checkout's kernels are built first, all at once, so
that no timed process shares the host with ``nvcc``. The card's name and
power limit come first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SHAPES = {"llama_1b": (8, 2048, 2048, 16, 4, 128, True),
          "vit_l": (32, 196, 196, 16, 16, 64, False),
          "d256": (8, 2048, 2048, 8, 2, 256, True),
          "d256_prefill": (8, 128, 128, 8, 2, 256, True)}
WITH_K1 = ("d256", "d256_prefill")  # shapes where the serving forward is timed as well
# fp32 shapes, where K1, K1', K2 and K3 are timed
F32_SHAPES = {"c5_prefill_fp32": (8, 128, 128, 16, 4, 128, True),
              "c5_fp32": (2, 512, 512, 16, 4, 128, True),
              "llama_1b_fp32": (8, 2048, 2048, 16, 4, 128, True)}
# K4's tables: (slots, fewest rows, most rows, pool pages, retired slots,
# table width in pages, dtype name)
PAGED = {"paged_attention": (64, 1, 512, 513, 4, 32, "bfloat16"),
         "paged_attention_f32": (8, 1, 512, 65, 1, 8, "float32"),
         "paged_attention_f32_long": (4, 1537, 2048, 129, 0, 32, "float32")}
ROUNDS = 5  # rounds of 200 K4 wrapper calls timed on the host clock


def _ms(torch, fn, sets, iters=20, warmup=3):
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, sets, iters=20, replays=5):
    fn(*sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def _paged_set(torch, seed, B=64, lo=1, hi=512, total_pages=513, trash_slots=4, max_pages=32,
               dtype="bfloat16", nh=16, nkv=4, D=128, ps=64):
    """K4's inputs: B slots of lo..hi rows on random pages (page 0 the trash
    page; the first ``trash_slots`` slots hold one row and an all-zero table
    row, as inactive slots do); q pre-scaled."""
    g = torch.Generator().manual_seed(seed)
    slot_pages = (total_pages - 1) // B
    lengths = torch.randint(lo, hi + 1, (B,), generator=g, dtype=torch.int32)
    lengths[:trash_slots] = 1
    perm = torch.randperm(total_pages - 1, generator=g) + 1
    table = torch.zeros((B, max_pages), dtype=torch.int32)
    for s in range(trash_slots, B):
        n = -(-int(lengths[s]) // ps)
        table[s, :n] = perm[s * slot_pages: s * slot_pages + n]
    gd = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    kp, vp = (torch.randn((nkv, total_pages, ps, D), generator=gd, device="cuda").to(dt)
              for _ in range(2))
    q = (torch.randn((B, nh, D), generator=gd, device="cuda") * D ** -0.5).to(dt)
    return q, kp, vp, table.cuda(), lengths.cuda()


def time_paged(torch, pd, table) -> dict:
    """K4's event-timed ms, graph-timed device_ms and host_us a wrapper call
    at ``table`` (a PAGED entry)."""
    sets = [_paged_set(torch, 40 + i, *table) for i in range(4)]
    result = {"ms": _ms(torch, pd.paged_attention, sets),
              "device_ms": _graph_ms(torch, pd.paged_attention, sets), "host_us": []}
    for _ in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(200):
            pd.paged_attention(*sets[i % len(sets)])
        result["host_us"].append((time.perf_counter() - t0) / 200 * 1e6)
        torch.cuda.synchronize()
    return result


def time_c5_train(torch) -> float:
    """ms a step of the c5 fp32 train step: llama_1b's width at 2 layers,
    fp32, save_attn, B2 S512, seed-0 state; 2 warm-up steps, then 5 timed."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train.step import (default_optimizer, make_train_state_factory,
                                          make_train_step)

    cfg = dataclasses.replace(LlamaConfig.llama_1b(max_seq_len=512), num_layers=2,
                              dtype=torch.float32, remat="save_attn")
    opt = default_optimizer(warmup_steps=0, total_steps=100)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                                (2, 512))).cuda()
    targets = torch.roll(tokens, -1, dims=1)
    step = make_train_step(cfg, opt)
    state = make_train_state_factory(cfg, opt)(seed=0, device="cuda")
    for _ in range(2):
        state, metrics = step(state, tokens, targets)
    metrics["loss"].item()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        state, metrics = step(state, tokens, targets)
    metrics["loss"].item()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 5 * 1e3


def _inputs(torch, ta, shape, dtype):
    """Two copies of (q, k, v, dout, lse, delta) at ``shape`` in ``dtype``."""
    b, sq, skv, hq, hkv, d, causal = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    sets = []
    for _ in range(2):
        q, dout = (torch.randn((b, sq, hq, d), generator=g, device="cuda").to(dtype)
                   for _ in range(2))
        k, v = (torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(dtype)
                for _ in range(2))
        fwd = ta.flash_attention_lse(q, k, v, causal)
        out, lse = fwd[0], fwd[1]
        sets.append((q, k, v, dout, lse, ta._delta(out, dout)))
    return sets


def _time_bwd(torch, ta, sets, causal, scale) -> dict:
    times = {}
    for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        fn = getattr(ta, kernel)
        try:
            times[kernel] = _ms(torch, lambda *a: fn(*a, causal, scale), sets)
        except ValueError:  # a checkout whose kernel does not take this shape
            times[kernel] = None
    return times


def time_checkout(root: str, paged_only: bool = False) -> dict:
    """Times of K1', K2, K3 and K4 (only K4 with ``paged_only``), of K1
    at D256, of K1, K1', K2, K3 and K4 in fp32 and of the c5 fp32 train
    step, from the
    checkout at ``root`` (run in a fresh process: it imports that
    checkout's package), with the launch counts of the calls (which
    kernels ran)."""
    sys.path.insert(0, root)
    import torch

    from ray_tpu_torch.models import paged_decode as pd
    from ray_tpu_torch.ops import attention as ta

    result = {"checkout": root}
    for name, shape in ({} if paged_only else SHAPES).items():
        causal, scale = shape[-1], shape[5] ** -0.5
        sets = _inputs(torch, ta, shape, torch.bfloat16)
        times = {"flash_fwd_lse": _ms(torch, lambda q, k, v, *_: ta.flash_attention_lse(
            q, k, v, causal), sets)}
        if name in WITH_K1:
            times["flash_fwd"] = _ms(torch, lambda q, k, v, *_: ta.flash_attention(
                q, k, v, causal), sets)
        result[name] = {**times, **_time_bwd(torch, ta, sets, causal, scale)}
        del sets
        torch.cuda.empty_cache()
    for name, shape in ({} if paged_only else F32_SHAPES).items():
        causal = shape[-1]
        sets = _inputs(torch, ta, shape, torch.float32)
        times = {"flash_fwd": _ms(torch, lambda q, k, v, *_: ta.flash_attention(
                     q, k, v, causal), sets),
                 "flash_fwd_lse": _ms(torch, lambda q, k, v, *_: ta.flash_attention_lse(
                     q, k, v, causal), sets)}
        result[name] = {**times, **_time_bwd(torch, ta, sets, causal, shape[5] ** -0.5)}
        del sets
        torch.cuda.empty_cache()
    if not paged_only:
        result["c5_train_fp32_ms"] = time_c5_train(torch)
        torch.cuda.empty_cache()
    for name, table in PAGED.items():
        result[name] = time_paged(torch, pd, table)
        torch.cuda.empty_cache()
    from ray_tpu_torch import _kernels

    result["launches"] = dict(_kernels.launch_counts)
    return result


def main() -> int:
    args = sys.argv[1:]
    paged = args[:1] == ["--paged"]
    args = args[1:] if paged else args
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(time_checkout(os.path.abspath(args[1]), paged)), flush=True)
        return 0
    if len(args) == 2 and args[0] == "--build":
        sys.path.insert(0, os.path.abspath(args[1]))
        from ray_tpu_torch import _kernels

        _kernels.build_all()
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    builds = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--build", root])
              for root in dict.fromkeys(args or [here])]
    if any(p.wait() for p in builds):
        raise RuntimeError("a checkout's kernels did not build")
    for root in args or [here]:
        subprocess.run([sys.executable, os.path.abspath(__file__)] + ["--paged"] * paged
                       + ["--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
