"""What the serving drivers share: the engine built from a cell's settings,
its warm-up, the host-side recorder of a traced run, the close of a run, and
the served sample the reference checks.

The recorder wraps two of ``LLMEngine``'s calls on the engine's own thread
(the decode chunk and a batched prefill) and notes, on the host, what each
was asked to do: for every slot, the rows its decode ticks needed, and the
unpadded length of every prompt prefilled. Nothing is read from the device,
so the run's timing is not changed beyond a few microseconds a chunk.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from typing import Dict, List

import numpy as np

CLOSED = "benchmark window closed"


def build(ctx, params):
    from ray_tpu_torch.serve.llm import LLMEngine

    e = ctx.workload["engine"]
    return LLMEngine(ctx.program_config(max_seq_len=e["max_seq_len"]), params,
                     device=ctx.device, num_slots=e["num_slots"],
                     max_seq_len=e["max_seq_len"], decode_chunk=e["decode_chunk"],
                     temperature=0.0, prefill_buckets=e["prefill_buckets"], paged=True,
                     page_size=e["page_size"], total_pages=e.get("total_pages"))


def warm_up(engine, ctx) -> None:
    """Every shape the cell's traffic uses: one prompt filling each prefill
    bucket (a batched prefill of that bucket; two tokens short where the
    bucket is the engine's whole context) and the decode chunk at the
    engine's slot count, together, until each has its tokens."""
    rng = np.random.default_rng([ctx.seed, 4])
    futures, out = [], []

    def one(n):
        out.append(engine.generate(rng.integers(0, ctx.dims.vocab, n).tolist(), max_tokens=2,
                                   timeout=600))

    for b in engine.prefill_buckets:
        t = threading.Thread(target=one, args=(min(b, engine.max_seq - 2),), daemon=True)
        t.start()
        futures.append(t)
    for t in futures:
        t.join(timeout=600)
    if len(out) != len(futures):
        raise RuntimeError("warm-up requests did not complete")


class Recorder:
    """Host-side notes of a traced run (see the module's docstring)."""

    def __init__(self, engine):
        self.chunks: List[tuple] = []  # (t_start_ns, t_end_ns, ticks, [(pos, remaining)])
        self.prefills: List[tuple] = []  # (t_start_ns, bucket, rows, [prompt lengths])
        decode, group = engine._decode, engine._prefill_group
        chunk = engine.decode_chunk

        def recorded_decode(*args, **kwargs):
            slots = []
            for req in engine._slots:
                if req is None:
                    continue
                k = len(req.out_tokens)
                pos = len(req.tokens) + k - 1 if k else len(req.tokens)
                slots.append((pos, req.max_tokens - max(k, 1)))
            t0 = time.time_ns()
            result = decode(*args, **kwargs)
            self.chunks.append((t0, time.time_ns(), chunk, slots))
            return result

        def recorded_group(items, bucket, size):
            self.prefills.append((time.time_ns(), bucket, size,
                                  [len(item[0].tokens) for item in items]))
            return group(items, bucket, size)

        engine._decode = recorded_decode
        engine._prefill_group = recorded_group

    def ticks_in(self, t0_ns: int, t1_ns: int) -> List[List[int]]:
        """Each decode tick launched in [t0, t1) (a chunk's ticks spread
        evenly over its launch), as the rows each slot that still needed a
        token read."""
        out = []
        for a, b, n, slots in self.chunks:
            for j in range(n):
                t = a + (b - a) * (j + 0.5) / n
                if t0_ns <= t < t1_ns:
                    out.append([pos + j + 1 for pos, rem in slots if j < rem])
        return out

    def loop_in(self, t0_ns: int, t1_ns: int) -> tuple:
        """(nanoseconds, ticks) of the decode chunks launched in [t0, t1),
        each from its launch to the next chunk's: the engine loop's period,
        prefills and host copies included."""
        ns = ticks = 0
        for (a, _, n, _), (b, _, _, _) in zip(self.chunks, self.chunks[1:]):
            if t0_ns <= a < t1_ns:
                ns, ticks = ns + b - a, ticks + n
        return ns, ticks

    def prefills_in(self, t0_ns: int, t1_ns: int) -> List[List[int]]:
        return [lens for t, _, _, lens in self.prefills if t0_ns <= t < t1_ns]


def traced_span(engine, ctx, w0_ns: int):
    """In a --trace 1 run: the profiler over the last ``trace_seconds`` of
    the window that opened at ``w0_ns`` (its stop takes the host for a while,
    so it comes when nothing more is due), and the engine's counters across
    that span. Call it on the main thread. Returns (tracer, counters), or
    (None, {}) untraced."""
    if not ctx.trace:
        return None, {}
    from perfbench.trace import Tracer

    span = min(ctx.workload["trace_seconds"], ctx.seconds)
    time.sleep(max(0.0, (w0_ns + (ctx.seconds - span) * 1e9 - time.time_ns()) / 1e9))
    tracer = Tracer(ctx.device)
    tracer.start()
    s0 = engine.stats()
    time.sleep(span)
    s1 = engine.stats()
    tracer.stop()
    return tracer, {k: s1[k] - s0[k] for k in ("decode_steps", "prefill_programs")}


def close(engine) -> None:
    """Stop the engine and fail what it still holds, so every client
    returns; the requests in flight at the close are not counted."""
    engine.stop()
    held = [r for r in engine._slots if r is not None] + list(engine._admit_backlog)
    while True:
        try:
            held.append(engine._pending.get_nowait())
        except queue.Empty:
            break
    for req in held:
        if not req.future.done():
            req.future.set_exception(RuntimeError(CLOSED))
        if req.stream_q is not None:
            req.stream_q.put(None)


def free(device) -> None:
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def sample(done: List[dict], seed: int, min_tokens: int, max_requests: int) -> List[dict]:
    """The requests the reference checks: the one with the most served
    tokens, then others drawn from the seed until ``min_tokens`` served
    tokens or ``max_requests`` requests."""
    if not done:
        return []
    order = sorted(done, key=lambda r: (-len(r["tokens"]), r["index"]))
    picked = [order[0]]
    rest = order[1:]
    rng = np.random.default_rng([seed, 3])
    for i in rng.permutation(len(rest)):
        if sum(len(r["tokens"]) for r in picked) >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(rest[i])
    return picked


def served_checks(ctx, params, picked: List[dict], prompts: Dict[int, np.ndarray]) -> dict:
    """The widest gap by which a served token's reference logit lies below
    the reference's best, over the sampled requests."""
    from perfbench import compare

    seqs = [(prompts[r["index"]], r["tokens"]) for r in picked]
    return {"logit_gap": compare.served_gap(ctx.dims, params, seqs),
            "sampled_tokens": sum(len(t) for _, t in seqs), "sample": seqs}


def control_checks(run) -> Dict[str, float]:
    """The run's checks with the control in the program's place: the
    reference in float8 picks the token at each position of the run's own
    sample, and the gap of that token is compared."""
    from perfbench import compare, weights

    params = weights.make(run.ctx.dims, run.ctx.seed, run.ctx.device, run.ctx.dtype)
    gap = compare.served_gap(run.ctx.dims, params, run.extra["sample"], first_by="fp8")
    return {**run.checks, "logit_gap": gap}
