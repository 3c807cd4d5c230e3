"""Training: ``make_train_step`` over ``llama_loss`` with ``default_optimizer``,
one batch of fresh rows a step (``traffic.train_batch``: token ids from the
seed, targets the tokens shifted by one).

Set-up builds one train state from the seed's weights and drives it through
its first ``check.steps`` steps through the same call and feed as the
window, reading what the comparison needs on the way: each step's loss, the
first gradient as the optimizer took it (its first moment after one update
over 1 - b1), and each leaf's change after the last of them. The window then
runs steps for ``--seconds`` and ends with a synchronising read of the loss.
With ``--trace 1`` the profiler covers ``trace_steps`` steps of the window.
Once the state is freed, the reference takes the same steps from the same
weights and rows in fp32.
"""

from __future__ import annotations

import time

import torch

from perfbench import compare, harness, serving, traffic, weights
from perfbench.reference import llama as ref
from perfbench.trace import Tracer


def run(ctx) -> "harness.Run":
    from ray_tpu_torch import _kernels
    from ray_tpu_torch.train.step import TrainState, default_optimizer, make_train_step

    d, st = ctx.dims, ctx.workload["step"]
    b, s, n_check = st["batch"], st["seq"], ctx.workload["check"]["steps"]
    cfg = ctx.program_config(max_seq_len=s, remat=st["remat"],
                             attention_impl=st["attention_impl"])
    opt = default_optimizer(**st["optimizer"])
    step = make_train_step(cfg, opt)
    params = weights.make(d, ctx.seed, ctx.device, ctx.dtype)
    state = TrainState(step=0, params=params, opt_state=opt.init(params))
    start = {k: v.detach().clone() for k, v in ref.leaves(params).items()}

    def feed(i):
        return traffic.train_batch(ctx.seed, i, b, s, d.vocab, ctx.device)

    losses, first_grad = [], {}
    for i in range(n_check):
        state, metrics = step(state, *feed(i))
        losses.append(float(metrics["loss"]))
        if i == 0:
            first_grad = {k: v / (1 - opt.b1) for k, v in ref.leaves(state.opt_state.mu).items()}
            first_grad = compare.leaf_norms(first_grad)
    change = compare.leaf_norms({k: v - start[k] for k, v in ref.leaves(state.params).items()})
    del start
    prog = {"losses": losses, "first_grad": first_grad, "change": change}

    k0 = dict(_kernels.launch_counts)
    sync(ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()  # the window's peak, not the set-up's copies
    w0, t_first = time.time_ns(), time.perf_counter()
    setup_s = t_first - ctx.t0
    i, n, traced, tracer = n_check, 0, 0, None
    trace_at = (ctx.seconds - st["trace_seconds"]) / 2 if ctx.trace else None
    while time.perf_counter() - t_first < ctx.seconds:
        if trace_at is not None and time.perf_counter() - t_first >= trace_at:
            trace_at = None
            tracer = Tracer(ctx.device)
            tracer.start()
            for _ in range(st["trace_steps"]):
                state, metrics = step(state, *feed(i))
                i, n, traced = i + 1, n + 1, traced + 1
            tracer.stop()
            continue
        state, metrics = step(state, *feed(i))
        i, n = i + 1, n + 1
    float(metrics["loss"])  # the window ends with a synchronising read
    w1 = time.time_ns()
    k1 = dict(_kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" else 0
    del state, params, metrics
    serving.free(ctx.device)
    tr = tracer.summary() if tracer else None

    checks = reference_checks(ctx, prog)
    plain = sum(k1.get(k, 0) - k0.get(k, 0) for k in ("attention_plain", "paged_attention_plain"))
    checks["plain_launches"] = plain
    return harness.Run(ctx=ctx, setup_s=setup_s, window=(w0, w1), attempted=n, failed=0,
                       checks=checks, memory_peak_bytes=peak, steps=n, tokens_per_step=b * s,
                       trace=tr, extra={"traced_steps": traced, "program": prog})


def reference_checks(ctx, prog: dict, precision: str = "exact", drop_half: bool = False,
                     detail: bool = False) -> dict:
    """The reference's first steps from the seed's weights and the same rows,
    and the numbers compared against the program's readings (``detail``: with
    the worst leaves and the reference's own readings)."""
    st = ctx.workload["step"]
    params = weights.make(ctx.dims, ctx.seed, ctx.device, ctx.dtype)
    batches = [traffic.train_batch(ctx.seed, i, st["batch"], st["seq"], ctx.dims.vocab,
                                   ctx.device) for i in range(len(prog["losses"]))]
    refr = ref.train_steps(ctx.dims, params, batches, ref.AdamW(**st["optimizer"]),
                           precision=precision, drop_half=drop_half)
    del params, batches
    serving.free(ctx.device)
    numbers = compare.train_numbers(prog, refr)
    if detail:
        return {**numbers, "reference": refr}
    return {k: numbers[k] for k in ("loss_gap", "grad_gap", "change_gap")}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
