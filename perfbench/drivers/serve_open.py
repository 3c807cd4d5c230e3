"""Open-loop serving: requests sent on a fixed schedule (``traffic.arrivals``,
Poisson at a fixed rate, gaps drawn as ``perfbench/traffic.py`` draws them),
whether or not earlier ones have returned, each from a thread of its own
through ``LLMEngine.generate`` (greedy, no end-of-sequence token).

The window opens ``ramp_seconds`` after the first send, so the queue has
reached its steady state, and takes the requests due in the next
``--seconds``. Each is timed from its scheduled send: time to first token =
how late it was sent + the engine's own time to first token. Sending stops at
the close; the requests due in the window are then waited for, up to
``drain_seconds``, and one that never answers counts as missing.
"""

from __future__ import annotations

import math
import threading
import time

import torch

from perfbench import harness, serving, traffic, weights


def run(ctx) -> "harness.Run":
    d, wl = ctx.dims, ctx.workload
    params = weights.make(d, ctx.seed, ctx.device, ctx.dtype)
    engine = serving.build(ctx, params)
    serving.warm_up(engine, ctx)
    reqs = traffic.make(wl["traffic"], d.vocab, ctx.seed)
    result = measure(ctx, engine, reqs)
    prompts = {r.index: r.prompt for r in reqs}
    del engine
    serving.free(ctx.device)
    return finish(ctx, params, result, prompts)


def measure(ctx, engine, reqs) -> dict:
    """Drive ``reqs`` into a warm engine on their schedule; close the engine."""
    from ray_tpu_torch import _kernels

    wl = ctx.workload
    if max(len(r.prompt) for r in reqs) > max(engine.prefill_buckets):
        raise ValueError("a prompt is longer than the largest prefill bucket, which was not warmed")
    recorder = serving.Recorder(engine) if ctx.trace else None
    ramp = wl["ramp_seconds"]
    records = {}
    lock = threading.Lock()

    def send(r, due_ns):
        sent = time.time_ns()
        rec = {"index": r.index, "prompt_len": len(r.prompt), "max_tokens": r.max_tokens,
               "due_ns": due_ns, "lag_s": (sent - due_ns) / 1e9, "ttft_sched_s": math.inf,
               "tokens": []}
        with lock:
            records[r.index] = rec
        try:
            out = engine.generate(r.prompt.tolist(), max_tokens=r.max_tokens)
        except RuntimeError as e:
            rec["error"] = repr(e)
            return
        rec.update(tokens=out["tokens"], ttft_s=out["ttft_s"], latency_s=out["latency_s"],
                   ttft_sched_s=rec["lag_s"] + out["ttft_s"])

    setup_s = time.perf_counter() - ctx.t0
    start = time.time_ns() + 5_000_000
    w0 = start + int(ramp * 1e9)
    w1 = w0 + int(ctx.seconds * 1e9)
    k0 = dict(_kernels.launch_counts)
    threads, ran_out = [], []

    def sender():
        for r in reqs:
            due = start + int(r.due * 1e9)
            if due >= w1:
                return
            delay = (due - time.time_ns()) / 1e9
            if delay > 0:
                time.sleep(delay)
            t = threading.Thread(target=send, args=(r, due), daemon=True)
            t.start()
            threads.append((due, t))
        ran_out.append(True)

    sending = threading.Thread(target=sender, daemon=True, name="sender")
    sending.start()
    tracer, counters = serving.traced_span(engine, ctx, w0)
    sending.join()
    if ran_out:
        raise ValueError("the cell's requests ran out before the window closed")
    drain = time.perf_counter() + wl["drain_seconds"]
    for due, t in threads:
        if w0 <= due < w1:
            t.join(timeout=max(0.0, drain - time.perf_counter()))
    k1 = dict(_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    serving.close(engine)
    for _, t in threads:
        t.join(timeout=60)
    with lock:
        in_window = [rec for rec in records.values() if w0 <= rec["due_ns"] < w1]
    plain = sum(k1.get(n, 0) - k0.get(n, 0) for n in ("attention_plain", "paged_attention_plain"))
    return {"setup_s": setup_s, "window": (w0, w1), "requests": in_window, "peak": peak,
            "plain": plain, "recorder": recorder, "tracer": tracer, "counters": counters}


def finish(ctx, params, m: dict, prompts) -> "harness.Run":
    tr = m["tracer"].summary() if m["tracer"] else None
    reqs = m["requests"]
    answered = [r for r in reqs if r["tokens"]]
    check = ctx.workload["check"]
    picked = serving.sample(answered, ctx.seed, check["min_tokens"], check["max_requests"])
    served = serving.served_checks(ctx, params, picked, prompts)
    checks = {"logit_gap": served["logit_gap"],
              "short_answers": sum(len(r["tokens"]) != r["max_tokens"] for r in answered),
              "plain_launches": m["plain"]}
    return harness.Run(
        ctx=ctx, setup_s=m["setup_s"], window=m["window"], attempted=len(reqs),
        failed=len(reqs) - len(answered), checks=checks, memory_peak_bytes=m["peak"],
        requests=reqs, counters=m["counters"], recorder=m["recorder"], trace=tr,
        extra={"sampled_tokens": served["sampled_tokens"], "sample": served["sample"]})
