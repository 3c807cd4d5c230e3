"""How far IMPALA's chain run clears its learning threshold, and what its
learner costs alone.

    python -m ray_tpu_torch.rl_spread                 # on the card, 12 runs
    python -m ray_tpu_torch.rl_spread --device cpu --runs 6

Runs tests/test_rl_platform.py's IMPALA configuration (the 6-state chain,
20 steps, hidden 32, 2 runners, B4 T20; threshold: episode_return_mean >
30 after 30 iterations) ``--runs`` times from seed 0 on the port's
in-process runtime, with the learner on ``--device``, and prints each
run's return and seconds; then times one update of the same shapes alone,
no runners stepping beside it (mean of 50, the loss read each time). The
runs differ only by thread timing: how far the runners get ahead of the
learner decides how stale the unrolls V-trace corrects are.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

CHAIN = dict(env="Chain-rt", env_config={"n": 6, "max_steps": 20}, hidden=(32,), num_runners=2,
             unroll_len=20, batch_unrolls=4, entropy_coef=0.02, lr=3e-3, seed=0)
ITERS, THRESHOLD = 30, 30.0


def learning_runs(runs: int, device) -> list:
    from ray_tpu_torch.rl import ImpalaConfig, ImpalaTrainer

    out = []
    for i in range(runs):
        trainer = ImpalaTrainer(ImpalaConfig(**CHAIN), total_unrolls_per_runner=2_000,
                                device=device)
        try:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                result = trainer.train()
            seconds = time.perf_counter() - t0
        finally:
            trainer.stop()
        out.append({"return": result["episode_return_mean"], "seconds": seconds,
                    "mean_rho": result["mean_rho"]})
        print(f"run {i}: episode_return_mean {result['episode_return_mean']:.2f} after {ITERS} "
              f"iterations in {seconds:.2f} s", flush=True)
    return out


def update_alone_ms(device, calls: int = 50) -> float:
    from ray_tpu_torch.rl import impala
    from ray_tpu_torch.rl.dqn import as_tree
    from ray_tpu_torch.train.step import adamw

    cfg = impala.ImpalaConfig(**CHAIN)
    params = impala.ac_init(6, 2, cfg.hidden, 0, device)
    opt = adamw(cfg.lr)
    state = opt.init(as_tree(params))
    update = impala.make_impala_update(cfg, opt)
    rng = np.random.default_rng(0)
    B, T = cfg.batch_unrolls, cfg.unroll_len
    batch = {"obs": rng.standard_normal((B, T, 6)).astype(np.float32),
             "next_obs_last": rng.standard_normal((B, 6)).astype(np.float32),
             "actions": rng.integers(0, 2, (B, T)), "rewards": np.ones((B, T), np.float32),
             "dones": np.zeros((B, T), np.float32),
             "behavior_logits": rng.standard_normal((B, T, 2)).astype(np.float32)}
    for _ in range(5):
        float(update(params, state, batch)[2])
    t0 = time.perf_counter()
    for _ in range(calls):
        float(update(params, state, batch)[2])
    return (time.perf_counter() - t0) / calls * 1e3


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help="the learner's device (default: the card)")
    parser.add_argument("--runs", type=int, default=12)
    args = parser.parse_args()

    import ray_tpu_torch
    from ray_tpu_torch._device import resolve_device

    device = resolve_device(args.device)
    where = "cpu"
    if device.type == "cuda":
        where = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    ray_tpu_torch.init(num_cpus=8)
    try:
        runs = learning_runs(args.runs, device)
    finally:
        ray_tpu_torch.shutdown()
    ms = update_alone_ms(device)
    returns = [r["return"] for r in runs]
    print(f"one IMPALA update alone on {where}: {ms:.3f} ms (the loss read)", flush=True)
    print(json.dumps({"device": where, "returns": returns, "min": min(returns),
                      "at_or_below_threshold": sum(r <= THRESHOLD for r in returns),
                      "update_alone_ms": ms}))


if __name__ == "__main__":
    main()
