"""Readings that set a cell's limits, at the cell's own size, many seeds in
one process (the benchmark's own runs do not run this):

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 20 [--control]

For each seed it runs the cell once (untraced) and prints one JSON line with
the numbers its check compares. ``--control`` adds the control's readings:
serving, the checks with the gap of the token the reference in float8 puts
first at each sampled position, through the harness's own verdict
(``control_checks``, ``control_correct``); training, the reference in float8 in the program's place,
and the fault of half the batch left out (the mean taken over the rest), both
against the fp32 reference. Training lines also give each leaf's norms where
the program and the reference differ most, and those of the norm gains.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)

    import torch

    from perfbench import compare, harness, serving

    if not torch.cuda.is_available():
        print("calibration reads the card; no CUDA device", file=sys.stderr)
        return 3
    wl = harness.load_json(harness.HERE / "workloads" / f"{args.workload}.json")
    cfg = harness.load_json(harness.HERE / "configs" / f"{wl['config']}.json")
    limits = harness.load_json(harness.HERE / "limits" / f"{args.workload}.json")
    for seed in map(int, args.seeds.split(",")):
        t = time.perf_counter()
        run = harness.run_cell(args.workload, wl, cfg, limits, seed, args.seconds, False,
                               torch.device("cuda", 0), t)
        line = {"seed": seed, "checks": run.checks, "attempted": run.attempted,
                "failed": run.failed, "run_s": time.perf_counter() - t,
                "memory_peak_bytes": run.memory_peak_bytes}
        if wl["driver"] == "train":
            from perfbench.drivers import train

            prog = run.extra["program"]
            line.update(setup_s=run.setup_s, steps=run.steps, window_s=run.window_s,
                        train_tok_s=harness.reader("train_tok_s")(run))
            line["program_losses"] = prog["losses"]
            exact = train.reference_checks(run.ctx, prog, detail=True)
            refr = exact.pop("reference")
            line["leaves"] = leaf_table(prog, refr)
            line["exact"] = exact
            if args.control:
                for name, kw in (("fp8", {"precision": "fp8"}), ("half_batch", {"drop_half": True})):
                    low = train.reference_checks(run.ctx, prog, detail=True, **kw)["reference"]
                    line[name] = compare.train_numbers(low, refr)
        else:
            line["sampled_tokens"] = run.extra["sampled_tokens"]
            if args.control:
                control = dataclasses.replace(run, checks=serving.control_checks(run))
                line["control_checks"] = harness.verdict(control)
                line["control_correct"] = harness.passed(line["control_checks"])
        print(json.dumps(line), flush=True)
        del run
    return 0


def leaf_table(prog: dict, refr: dict, worst: int = 6) -> dict:
    """The leaves whose change differs most, and every norm gain's."""
    rows = {}
    gaps = sorted(refr["change"], key=lambda k: -abs(prog["change"][k] - refr["change"][k])
                  / max(refr["change"][k], 1e-30))
    for k in gaps[:worst] + [k for k in refr["change"] if "norm" in k][:4]:
        rows[k] = {"change": [prog["change"][k], refr["change"][k]],
                   "first_grad": [prog["first_grad"][k], refr["first_grad"][k]]}
    return rows


if __name__ == "__main__":
    sys.exit(main())
