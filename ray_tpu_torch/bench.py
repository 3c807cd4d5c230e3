"""Training throughput of the port on one card: the counterpart of the train
measurement in the repository's ``bench.py`` (which measures the JAX package).

    python -m ray_tpu_torch.bench            # prints one JSON line

Same configuration and data as ``bench.py``'s single-chip run:
``LlamaConfig.llama_1b(max_seq_len=2048, remat="save_attn",
attention_impl="flash")``, batch 8, sequence 2048,
``default_optimizer(warmup_steps=10, total_steps=1000)``, tokens from
``np.random.default_rng(0)`` with ``targets = roll(tokens, -1)``, random
weights from seed 0; 3 warm-up steps, then 20 timed steps ended by a
synchronising read of the loss. MFU uses ``bench.py``'s count of
``6 N + 6 L H S`` FLOPs per token against the card's bf16 dense peak from
its name. With no card it returns ``skipped: true`` and no number.
Beside it, ``object_transfer``: MB/s of a 16 MB object pulled between two
node agents of the port's cluster (``measure_object_transfer``, the key
``bench.py`` prints; ``RAY_TPU_BENCH_TRANSFER=0`` leaves it out).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ray_tpu_torch import _kernels
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.train.step import default_optimizer, make_train_state_factory, make_train_step

METRIC = "llama_train_tokens_per_sec_per_chip"

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, HBM B/s.
PEAKS = {
    "H100 SXM": (989e12, 3.35e12),
    "H100 PCIe": (756e12, 2.0e12),
    "H200 SXM": (989e12, 4.8e12),
}


def peaks_for(name: str):
    """(key, (bf16 FLOP/s, HBM B/s)) for a card's name; H100 SXM when unknown."""
    if "H200" in name:
        key = "H200 SXM"
    elif "H100" in name and "PCIe" in name:
        key = "H100 PCIe"
    else:
        key = "H100 SXM"
        if "H100" not in name:
            print(f"warning: no peaks known for {name!r}; using {key}'s", flush=True)
    return key, PEAKS[key]


def train_bench(steps: int = 20, warmup: int = 3) -> dict:
    """Run the measurement. ``per_step`` holds each timed step's loss,
    grad_norm and kernel launches (read after the timed region)."""
    if not torch.cuda.is_available():
        return {"metric": METRIC, "skipped": True, "reason": "no CUDA device"}
    config = LlamaConfig.llama_1b(max_seq_len=2048, remat="save_attn", attention_impl="flash")
    batch, seq = 8, 2048
    opt = default_optimizer(warmup_steps=10, total_steps=1000)
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state_factory(config, opt)(seed=0, device="cuda")
    step = make_train_step(config, opt)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, config.vocab_size, (batch, seq))).cuda()
    targets = torch.roll(tokens, -1, dims=1)

    for _ in range(warmup):
        state, metrics = step(state, tokens, targets)
    torch.cuda.synchronize()
    _kernels.reset_counts()
    per_step = []
    t0 = time.perf_counter()
    for _ in range(steps):
        before = dict(_kernels.launch_counts)
        state, metrics = step(state, tokens, targets)
        per_step.append((metrics, {n: c - before.get(n, 0)
                                   for n, c in _kernels.launch_counts.items()}))
    final_loss = float(metrics["loss"])
    dt = time.perf_counter() - t0
    launches = dict(_kernels.launch_counts)

    name = torch.cuda.get_device_name(0)
    _, (peak, _) = peaks_for(name)
    tokens_per_sec = batch * seq * steps / dt
    n_params = config.num_params
    flops_per_token = 6 * n_params + 6 * config.num_layers * config.hidden_size * seq
    return {
        "metric": METRIC,
        "value": round(tokens_per_sec, 1),
        "unit": "tokens/s",
        "mfu": round(tokens_per_sec * flops_per_token / peak, 4),
        "chip": name,
        "model_params": n_params,
        "batch": batch,
        "seq": seq,
        "loss": round(final_loss, 4),
        "step_ms": dt / steps * 1e3,
        "steps": steps,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "per_step": [{"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
                      "launches": {n: c for n, c in counts.items() if c}}
                     for m, counts in per_step],
    }


def measure_object_transfer(size: int = 16 << 20) -> dict:
    """Data-plane sample beside the train number (the counterpart of
    ``bench.py:measure_object_transfer``): MB/s of one object of ``size``
    bytes pulled by a second node agent from the head's store, on a
    two-node cluster of the port on this host (agents and workers are
    subprocesses; the store is the shared-memory arena). ``raw_transfer``
    says the second agent counted a pull."""
    import ray_tpu_torch
    from ray_tpu_torch.cluster import Cluster
    from ray_tpu_torch.core.rpc import SyncRpcClient

    cluster = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
    try:
        node2 = cluster.add_node(num_cpus=1)
        cluster.wait_for_nodes(2, timeout=60)
        ray_tpu_torch.init(address=cluster.gcs_address)
        payload = np.zeros(size, dtype=np.uint8)
        ref = ray_tpu_torch.put(payload)
        agent2 = SyncRpcClient(node2.address)
        try:
            t0 = time.perf_counter()
            agent2.call("ensure_local", object_id=ref.id.hex(),
                        timeout_s=120.0, timeout=130.0)
            dt = time.perf_counter() - t0
            stats = agent2.call("transfer_stats")
        finally:
            agent2.close()
        return {
            "pull_mbps": round(size / dt / 1e6, 1),
            "bytes": size,
            "raw_transfer": bool((stats.get("pulls", 0) or 0) >= 1),
        }
    finally:
        try:
            ray_tpu_torch.shutdown()
        finally:
            cluster.shutdown()


def main() -> int:
    result = train_bench()
    # data-plane sample (opt out: RAY_TPU_BENCH_TRANSFER=0), as bench.py's
    if os.environ.get("RAY_TPU_BENCH_TRANSFER", "1") != "0":
        try:
            result["object_transfer"] = measure_object_transfer()
        except Exception as e:  # noqa: BLE001 - never sink the train number
            result["object_transfer"] = {
                "skipped": True, "error": f"{type(e).__name__}: {e}"[:200]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
