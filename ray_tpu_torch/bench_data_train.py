"""Data -> train end to end on the card: an image pipeline feeding the ViT
train step (the counterpart of tools/bench_data_train.py).

    python -m ray_tpu_torch.bench_data_train [--images 512] [--steps 20] [--batch 32] [--out F]

``ray_tpu_torch.data`` reads and decodes PNG files written from a seed
(``read_images``, resized to 224 px), normalizes them with ``map_batches``,
streams them through ``streaming_split(1)`` and ``iter_torch_batches``
(pinned memory, side-stream copies, ``config.device_prefetch_depth`` batches
ahead), and ViT-L/16 (224 px, 1000 classes, bf16, random weights from seed
0) trains on them with ``make_vit_train_step`` and ``train.step.adamw(1e-3)``.
One warm-up step, then ``--steps`` timed steps; the pipeline is read again
(a new epoch) whenever it runs out. Prints ONE JSON line with the reference
bench's keys: images/s, the busy fraction (``vs_baseline``) and the
input-starved fraction (the share of the wall time the step was not
running: the pipeline kept the card waiting), the per-operator stats of the
last epoch's execution and its peak in-flight blocks. Each step ends in a
synchronize (``loss.item()``), as the reference's ``jax.device_get(loss)``
does. With no card it prints ``skipped: true`` and no number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

METRIC = "data_to_train_images_per_sec"


def write_corpus(directory: str, n: int, side: int, seed: int = 0) -> None:
    """``n`` PNGs of seeded uint8 noise, ``side + i % 16`` rows by ``side``
    columns (the reference bench's corpus), so read_images has to resize."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    for i in range(n):
        arr = rng.integers(0, 255, (side + (i % 16), side, 3), np.uint8)
        Image.fromarray(arr).save(os.path.join(directory, f"im{i:05d}.png"))


def image_pipeline(corpus: str, side: int, num_classes: int):
    """read_images -> map_batches(normalize), as the reference bench builds
    it: float32 images in [0, 1] and a label from each image's sum."""
    import numpy as np

    from ray_tpu_torch import data as rd

    def normalize(batch):
        x = batch["image"].astype(np.float32) / 255.0
        return {"image": x, "label": (x.sum(axis=(1, 2, 3)) % num_classes).astype(np.int64)}

    return rd.read_images(corpus, size=(side, side), files_per_block=64).map_batches(normalize)


def data_train(images: int = 512, steps: int = 20, batch: int = 32, config=None,
               device=None, keep: int = 0, corpus: Optional[str] = None):
    """Run the bench; returns (the JSON result, extras). ``config``: a
    ``ViTConfig`` (default ViT-L/16 at 224 px); ``device``: None is the card
    (skipped without one), "cpu" rehearses on the CPU. ``extras`` holds the
    per-step losses (tensors), the kernel launches of each timed step, and
    (with ``keep``) ``batches``: the warm-up batch, then the first ``keep``
    timed batches,
    for chip_smoke.py's checks. ``corpus``: a directory of images to read
    (default: ``images`` PNGs written to a temporary directory, removed at
    the end). The runtime is started here (``ray_tpu_torch.init(num_cpus=8)``)
    and shut down before it returns."""
    import shutil

    import torch

    if device is None and not torch.cuda.is_available():
        return {"metric": METRIC, "skipped": True, "reason": "no CUDA device"}, {}
    import ray_tpu_torch
    from ray_tpu_torch import _kernels
    from ray_tpu_torch.data.execution.stats import format_stats_table
    from ray_tpu_torch.models.vit import ViTConfig, make_vit_train_step
    from ray_tpu_torch.train.step import adamw

    config = config or ViTConfig.vit_l(image_size=224)
    side = config.image_size
    dev = torch.device("cuda" if device is None else device)
    own_corpus = corpus is None
    corpus = corpus or tempfile.mkdtemp(prefix="vit_bench_")
    if own_corpus:
        write_corpus(corpus, images, side)

    ray_tpu_torch.init(num_cpus=8)
    try:
        ds = image_pipeline(corpus, side, config.num_classes)
        step, init = make_vit_train_step(config, adamw(1e-3))
        params, opt_state = init(seed=0, device=dev)

        def epochs():
            while True:
                (shard,) = ds.streaming_split(1)
                yield from shard.iter_torch_batches(batch_size=batch, prefetch_batches=2,
                                                    device=dev)

        it = epochs()
        first = next(it)  # warm-up: allocations and the kernels' first launches
        kept: List[Dict[str, Any]] = [{k: v.clone() for k, v in first.items()}] if keep else []
        params, opt_state, loss = step(params, opt_state, first["image"], first["label"])
        loss.item()

        losses: List[Any] = []
        launches: List[Dict[str, int]] = []
        seen, compute_s = 0, 0.0
        t0 = time.perf_counter()
        for _ in range(steps):
            b = next(it)
            if keep and len(kept) <= keep:
                kept.append({k: v.clone() for k, v in b.items()})
            before = dict(_kernels.launch_counts)
            tc = time.perf_counter()
            params, opt_state, loss = step(params, opt_state, b["image"], b["label"])
            loss.item()  # the step ends on the card, as jax.device_get(loss) in the reference
            compute_s += time.perf_counter() - tc
            launches.append({n: c - before.get(n, 0) for n, c in _kernels.launch_counts.items()
                             if c != before.get(n, 0)})
            losses.append(loss)
            seen += int(b["image"].shape[0])
        wall = time.perf_counter() - t0
        it.close()

        per_op = ds.stats_rows()
        executor = getattr(ds, "_last_executor", None)
        peak_blocks = executor.peak_total_blocks if executor is not None else None
        table = format_stats_table(per_op, collect_rows=False)
    finally:
        ray_tpu_torch.shutdown()
        if own_corpus:
            shutil.rmtree(corpus, ignore_errors=True)
    result = {
        "metric": METRIC,
        "value": round(seen / wall, 1),
        "unit": "images/s",
        "vs_baseline": round(compute_s / max(wall, 1e-9), 4),  # busy fraction
        "input_starved_fraction": round(max(0.0, wall - compute_s) / max(wall, 1e-9), 4),
        "steps": len(losses),
        "batch": batch,
        "model_params": config.num_params,
        "image_size": side,
        "on_tpu": False,  # the reference bench's key; the port runs on the card
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "per_op_stats": per_op,
        "peak_in_flight_blocks": peak_blocks,
    }
    return result, {"losses": losses, "launches": launches, "batches": kept,
                    "stats_table": table}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--images", type=int, default=512)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    result, extras = data_train(args.images, args.steps, args.batch)
    if "stats_table" in extras:
        print("-- per-op pipeline stats --", file=sys.stderr)
        print(extras["stats_table"], file=sys.stderr)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
