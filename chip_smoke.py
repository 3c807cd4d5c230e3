#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                 # one card; takes no arguments

Phases, all of them on every run, in this order:
  device   card name and power limit (nvidia-smi); builds every kernel from
           ray_tpu_torch/csrc/ and prints the build time and ptxas report.
  kernels  each kernel against its plain PyTorch version on the card, in
           bf16, at the serving path's shapes; max abs error against a
           stated tolerance; kernel, plain, library and bound times.
  model    llama_1b at full width (random weights from a seed): one batched
           paged_prefill and a few paged_decode_one ticks, once through the
           kernels and once through the plain versions; logits compared.
  serve    LLMEngine(llama_1b, paged) serving 64 concurrent greedy requests;
           every request returns its tokens, and the kernels' launch counts
           match the engine's prefill programs and decode ticks exactly.

Prints {"kernels": [...]} and the nvidia-smi line before the last line; the
last line is {"ok": true, "device": {...}} only when every phase passed. Any
failure exits non-zero and prints no result. A copy of the results goes to
build/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

PHASES = ("device", "kernels", "model", "serve")

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, HBM B/s.
PEAKS = {
    "H100 SXM": (989e12, 3.35e12),
    "H100 PCIe": (756e12, 2.0e12),
    "H200 SXM": (989e12, 4.8e12),
}

# Tolerance, bf16 kernel output against the plain version (fp32 math on the
# same bf16 inputs, output rounded to bf16): |kernel - plain| <= ATOL + RTOL *
# |plain| elementwise. RTOL is PyTorch's bf16 default (two ulps of bf16's
# 8-bit mantissa: both sides round to bf16 once); ATOL covers outputs near 0,
# where the kernel's bf16 probabilities in P.V leave absolute error.
KERNEL_RTOL, KERNEL_ATOL = 1.6e-2, 1e-2
# Model logits, kernel path against plain path: bf16 activations through 22
# layers; max abs difference relative to the largest plain logit.
MODEL_RTOL = 5e-2

FLASH_SRC = "ray_tpu_torch/csrc/flash_fwd.cu"
PAGED_SRC = "ray_tpu_torch/csrc/paged_attention.cu"


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def peaks_for(name: str):
    if "H200" in name:
        key = "H200 SXM"
    elif "H100" in name and "PCIe" in name:
        key = "H100 PCIe"
    elif "H100" in name:
        key = "H100 SXM"
    else:
        key = "H100 SXM"
        print(f"warning: no peaks known for {name!r}; bounds use {key}'s", flush=True)
    return key, PEAKS[key]


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


# --------------------------------------------------------------------------- #
def phase_device(ctx):
    import torch

    from ray_tpu_torch import _kernels

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
    for name in ("flash_fwd", "paged_attention"):
        for line in _kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
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
    # The serve phase's engine: 64 slots, page size 64, 513 pages, and a block
    # table as wide as max_seq_len / page_size = 2048 / 64 = 32 pages; slots
    # hold 1..512 rows (at most 8 pages each, 512 real pages in all).
    B, nh, nkv, D, ps, max_pages, total_pages = 64, 16, 4, 128, 64, 32, 513
    slot_pages = (total_pages - 1) // B

    def paged_inputs(seed):
        g = torch.Generator().manual_seed(seed)
        lengths = torch.randint(1, slot_pages * ps + 1, (B,), generator=g, dtype=torch.int32)
        lengths[:4] = 1                       # inactive-like slots: all-trash table rows
        perm = torch.randperm(total_pages - 1, generator=g) + 1
        table = torch.zeros((B, max_pages), dtype=torch.int32)
        for s in range(4, B):
            n = -(-int(lengths[s]) // ps)
            table[s, :n] = perm[s * slot_pages: s * slot_pages + n]
        gd = torch.Generator(device="cuda").manual_seed(seed)
        kp = torch.randn((nkv, total_pages, ps, D), generator=gd, device="cuda").to(torch.bfloat16)
        vp = torch.randn((nkv, total_pages, ps, D), generator=gd, device="cuda").to(torch.bfloat16)
        q = (torch.randn((B, nh, D), generator=gd, device="cuda") * D ** -0.5).to(torch.bfloat16)
        return q, kp, vp, table.cuda(), lengths.cuda()

    q, kp, vp, table, lengths = paged_inputs(30)
    out = pd.paged_attention(q, kp, vp, table, lengths)
    ref = pd._paged_attention_reference(q, kp, vp, table, lengths, 1.0)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ratio = close_ratio(out, ref)
    require(bool(torch.isfinite(out).all()), "paged_attention: non-finite output")
    print(f"paged_attention (B{B} nh{nh} nkv{nkv} D{D} ps{ps}): max_abs_err {err:.3e}, worst "
          f"error / (atol {KERNEL_ATOL} + rtol {KERNEL_RTOL} |plain|) = {ratio:.3f} "
          "(must be <= 1)", flush=True)
    require(ratio <= 1.0, f"paged_attention disagrees: ratio {ratio}")
    sets = [paged_inputs(40 + i) for i in range(4)]
    ms = cuda_ms(torch, pd.paged_attention, sets)
    plain = cuda_ms(torch, lambda *a: pd._paged_attention_reference(*a, 1.0), sets, iters=5)
    rows = sum(int(s[4].sum()) for s in sets) / len(sets)  # K/V rows this data reads
    flops = 4.0 * nh * D * rows
    nbytes = 2.0 * (2 * B * nh * D + 2 * rows * nkv * D) + 4.0 * (B * max_pages + B)
    bms, by = bound_ms(flops, nbytes, peaks)
    ctx["k4"] = {"name": "paged_attention", "route": "cuda", "source": PAGED_SRC,
                 "replaces": "ray_tpu/models/paged_decode.py:93", "max_abs_err": err,
                 "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                 "library_ms": None, "shape": [B, nh, nkv, D, ps, max_pages]}
    print(f"paged_attention: {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by}) "
          f"on {ctx['card']}", flush=True)


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

    # launches: the serve phase's counts, the only run of the main path
    kernels = [dict(ctx[key], launches=ctx["launches"][ctx[key]["name"]])
               for key in ("k1", "k4")]
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        print(f"chip_smoke: kernels never launched on the main path: {idle}", file=sys.stderr)
        return 1
    record = {"card": ctx["card"], "smi": ctx["smi"], "build_s": ctx["build_s"],
              "peaks": ctx["peaks_key"], "kernels": kernels,
              "model_rel_err": ctx["model_rel_err"], "serve": ctx["serve"]}
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "shape"}
                                  for e in kernels]}))
    print(ctx["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": ctx["card"],
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
