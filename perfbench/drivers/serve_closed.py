"""Closed-loop serving: ``traffic.clients`` clients each send their next
request as soon as their last one returns (``LLMEngine.generate_stream``,
greedy, no end-of-sequence token), drawing in turn from one queue of the
cell's requests. The first request of each client is one caught in flight
(``traffic.first_round``: its prompt holds what it has already produced), so
the loop starts in its steady state.

The window opens once every client's first request has been admitted (the
engine reports every client's slot active) and lasts ``--seconds``. Each
client notes when each host copy of tokens reaches it; tokens a second is
every token the engine produced in the window, each request's tokens spread
evenly between the copies that brought them (from its send to its first
copy, then copy to copy), so the count does not step with the 32-tick
chunks. After the close the engine runs on until each request in flight has
had a copy past it. Tails take the requests completed in the window. With
``--trace 1`` the profiler covers ``trace_seconds`` in the middle.
"""

from __future__ import annotations

import threading
import time

import torch

from perfbench import harness, serving, traffic, weights

COPY_NS = 5_000_000  # tokens reaching a client closer together came in one copy
ADMIT_TIMEOUT_S = 300  # the longest the clients' first requests may take to be admitted


def run(ctx) -> "harness.Run":
    from ray_tpu_torch import _kernels

    d, wl = ctx.dims, ctx.workload
    params = weights.make(d, ctx.seed, ctx.device, ctx.dtype)
    engine = serving.build(ctx, params)
    serving.warm_up(engine, ctx)
    reqs = traffic.make(wl["traffic"], d.vocab, ctx.seed)
    if max(len(r.prompt) for r in reqs) > max(engine.prefill_buckets):
        raise ValueError("a prompt is longer than the largest prefill bucket, which was not warmed")
    recorder = serving.Recorder(engine) if ctx.trace else None
    clients = min(wl["traffic"]["clients"], engine.num_slots)
    feed = iter(reqs)
    lock = threading.Lock()
    stop = threading.Event()
    streams = []

    def client():
        while not stop.is_set():
            with lock:
                r = next(feed, None)
            if r is None:
                return
            rec = {"index": r.index, "max_tokens": r.max_tokens, "sent_ns": time.time_ns(),
                   "copies": [], "tokens": []}
            streams.append(rec)
            try:
                for item in engine.generate_stream(r.prompt.tolist(), max_tokens=r.max_tokens):
                    now = time.time_ns()
                    if "token" not in item:
                        rec.update(done_ns=now, ttft_s=item["ttft_s"], latency_s=item["latency_s"])
                        continue
                    rec["tokens"].append(item["token"])
                    copies = rec["copies"]
                    if copies and now - copies[-1][0] < COPY_NS:
                        copies[-1] = [now, len(rec["tokens"])]
                    else:
                        copies.append([now, len(rec["tokens"])])
            except RuntimeError as e:
                if serving.CLOSED not in str(e):
                    rec["error"] = repr(e)

    setup_s = time.perf_counter() - ctx.t0
    threads = [threading.Thread(target=client, daemon=True, name=f"client-{i}")
               for i in range(clients)]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + ADMIT_TIMEOUT_S
    while engine.stats()["active"] < clients:
        if time.perf_counter() > deadline:
            raise RuntimeError("the clients' first requests were not all admitted")
        time.sleep(0.005)
    k0 = dict(_kernels.launch_counts)
    w0 = time.time_ns()
    tracer, counters = serving.traced_span(engine, ctx, w0)
    time.sleep(max(0.0, (w0 + ctx.seconds * 1e9 - time.time_ns()) / 1e9))
    w1 = time.time_ns()
    k1 = dict(_kernels.launch_counts)
    stop.set()
    deadline = time.perf_counter() + wl["tail_seconds"]
    while time.perf_counter() < deadline and any(
            "done_ns" not in s and "error" not in s and (not s["copies"] or s["copies"][-1][0] < w1)
            for s in list(streams)):
        time.sleep(0.01)
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    serving.close(engine)
    for t in threads:
        t.join(timeout=60)
    done = [s for s in streams if w0 <= s.get("done_ns", -1) < w1]
    bad = [s for s in streams if "error" in s]
    prompts = {r.index: r.prompt for r in reqs}
    del engine
    serving.free(ctx.device)
    tr = tracer.summary() if tracer else None
    check = wl["check"]
    picked = serving.sample(done, ctx.seed, check["min_tokens"], check["max_requests"])
    served = serving.served_checks(ctx, params, picked, prompts)
    plain = sum(k1.get(n, 0) - k0.get(n, 0) for n in ("attention_plain", "paged_attention_plain"))
    checks = {"logit_gap": served["logit_gap"],
              "short_answers": sum(len(r["tokens"]) != r["max_tokens"] for r in done),
              "plain_launches": plain}
    return harness.Run(
        ctx=ctx, setup_s=setup_s, window=(w0, w1), attempted=len(done) + len(bad),
        failed=len(bad), checks=checks, memory_peak_bytes=peak, requests=done,
        counters=counters, recorder=recorder, trace=tr,
        extra={"sampled_tokens": served["sampled_tokens"], "sample": served["sample"],
               "streams": [(s["sent_ns"], s["copies"]) for s in streams]})
