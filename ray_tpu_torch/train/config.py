"""Train configuration dataclasses (own copy of ray_tpu.train.config).

Reference capability: python/ray/air/config.py (ScalingConfig, RunConfig,
FailureConfig, CheckpointConfig). Where the JAX package's workers hold
``tpus_per_worker`` TPU chips (``use_tpu``), the port's hold
``gpus_per_worker`` cards (``use_gpu``), under the ``GPU`` resource.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: int = 0
    cpus_per_worker: float = 1.0
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    placement_strategy: str = "PACK"

    def worker_resources(self) -> Dict[str, float]:
        res = {"CPU": float(self.cpus_per_worker), **self.resources_per_worker}
        if self.use_gpu or self.gpus_per_worker:
            res["GPU"] = float(self.gpus_per_worker or 1)
        return {k: v for k, v in res.items() if v}

    def bundles(self) -> list:
        return [self.worker_resources() for _ in range(self.num_workers)]


@dataclass
class FailureConfig:
    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)

    def resolved_storage_path(self) -> str:
        base = self.storage_path or os.path.expanduser("~/ray_tpu_torch_results")
        name = self.name or "train_run"
        return os.path.join(base, name)
