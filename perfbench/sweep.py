"""The knee of an open-loop cell: the cell's traffic at several fixed rates,
one engine after another in one process, each for ``--seconds``:

    python3 perfbench/sweep.py --workload mistral7b.prefill --rates 1,2,3 --seconds 30 --seed 5

One JSON line a rate: requests due in the window, the share answered, time to
first token from the scheduled send (p50, p95, and the median of the window's
first and second halves: a backlog that grows shows as the second above the
first), and answered requests a second. The cell's rate is set once, at about
0.8 of the highest rate sustained, and written into its workload file.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)

    import torch

    from perfbench import harness, serving, traffic, weights
    from perfbench.drivers import serve_open
    from perfbench.stats import percentile

    if not torch.cuda.is_available():
        print("the sweep reads the card; no CUDA device", file=sys.stderr)
        return 3
    wl = harness.load_json(harness.HERE / "workloads" / f"{args.workload}.json")
    cfg = harness.load_json(harness.HERE / "configs" / f"{wl['config']}.json")
    dev = torch.device("cuda", 0)
    params = None
    for rate in map(float, args.rates.split(",")):
        w = copy.deepcopy(wl)
        w["traffic"]["arrivals"]["rate"] = rate
        ctx = harness.Ctx(cell=args.workload, workload=w, config=cfg, limits={}, seed=args.seed,
                          seconds=args.seconds, trace=False, device=dev, t0=time.perf_counter())
        if params is None:
            params = weights.make(ctx.dims, args.seed, dev, ctx.dtype)
        engine = serving.build(ctx, params)
        serving.warm_up(engine, ctx)
        m = serve_open.measure(ctx, engine, traffic.make(w["traffic"], ctx.dims.vocab, args.seed))
        del engine
        serving.free(dev)
        reqs = sorted(m["requests"], key=lambda r: r["due_ns"])
        ttft = [r["ttft_sched_s"] for r in reqs]
        half = len(ttft) // 2
        answered = [r for r in reqs if r["tokens"]]
        print(json.dumps({
            "rate": rate, "due": len(reqs), "answered_share": len(answered) / max(1, len(reqs)),
            "ttft_p50_s": percentile(ttft, 50), "ttft_p95_s": percentile(ttft, 95),
            "ttft_first_half_p50_s": percentile(ttft[:half], 50),
            "ttft_second_half_p50_s": percentile(ttft[half:], 50),
            "send_lag_p95_s": percentile([r["lag_s"] for r in reqs], 95),
            "answered_per_s": len(answered) / args.seconds,
        }, default=lambda x: None if isinstance(x, float) and math.isinf(x) else x), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
