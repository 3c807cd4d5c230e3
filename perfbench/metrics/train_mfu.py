"""Model FLOPs of the traced steps (``bench.py``'s 6 N + 6 L H S a token)
over the traced window at the bf16 peak, in %."""

from perfbench import arith


def read(run):
    n = run.extra.get("traced_steps", 0)
    if run.trace is None or not n:
        return None
    seq = run.ctx.workload["step"]["seq"]
    flops = n * run.tokens_per_step * arith.train_flops_per_token(run.ctx.dims, seq)
    return 100.0 * flops / (run.trace.window_s * arith.PEAK_BF16_FLOPS)
