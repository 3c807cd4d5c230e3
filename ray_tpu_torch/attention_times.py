"""Times of the training path's attention kernels on one card (K1', the
forward with lse; K2, dQ; K3, dK/dV), for comparing two checkouts of this
repository in one run on one card.

    python3 ray_tpu_torch/attention_times.py [CHECKOUT ...]

Each CHECKOUT is the root of a checkout (default: the one this file lies
in). Each is timed in a process of its own, in the order given, so
``OLD NEW NEW OLD`` compares two commits in turns. A process imports
``ray_tpu_torch`` from its checkout, builds that checkout's kernels there,
and calls only what every checkout since the flash backward (K2, K3) has:
``flash_attention_lse``, ``_delta``, ``flash_bwd_dq`` and ``flash_bwd_dkv``.
The shapes are llama_1b's training attention (B8, S2048, 16 q heads over 4,
D128, causal) and ViT-L/16's (B32, S196, 16 heads over 16, D64, not
causal); a shape a checkout's kernels refuse is reported as null. Each line
of output is one checkout's JSON: ms a call (mean of 20 calls between CUDA
events, inputs cycling over two copies larger than the L2), per kernel and
shape. The card's name and power limit come first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = {"llama_1b": (8, 2048, 2048, 16, 4, 128, True),
          "vit_l": (32, 196, 196, 16, 16, 64, False)}


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


def time_checkout(root: str) -> dict:
    """Times of K1', K2 and K3 from the checkout at ``root`` (run in a fresh
    process: it imports that checkout's package)."""
    sys.path.insert(0, root)
    import torch

    from ray_tpu_torch.ops import attention as ta

    result = {"checkout": root}
    for name, (b, sq, skv, hq, hkv, d, causal) in SHAPES.items():
        scale = d ** -0.5
        g = torch.Generator(device="cuda").manual_seed(0)
        sets = []
        for _ in range(2):
            q, dout = (torch.randn((b, sq, hq, d), generator=g, device="cuda").to(torch.bfloat16)
                       for _ in range(2))
            k, v = (torch.randn((b, skv, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            fwd = ta.flash_attention_lse(q, k, v, causal)
            out, lse = fwd[0], fwd[1]
            sets.append((q, k, v, dout, lse, ta._delta(out, dout)))
        times = {"flash_fwd_lse": _ms(torch, lambda q, k, v, *_: ta.flash_attention_lse(
            q, k, v, causal), sets)}
        for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
            fn = getattr(ta, kernel)
            try:
                times[kernel] = _ms(torch, lambda *a: fn(*a, causal, scale), sets)
            except ValueError:  # a checkout whose kernel does not take this shape
                times[kernel] = None
        result[name] = times
        del sets
        torch.cuda.empty_cache()
    return result


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(time_checkout(os.path.abspath(sys.argv[2]))), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for root in sys.argv[1:] or [here]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
