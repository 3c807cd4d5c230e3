from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.session import (Checkpoint, get_checkpoint, get_context, report,
                                         world_rank, world_size)
from ray_tpu_torch.train.trainer import GpuTrainer, Result

# The train step's names load on first use (PEP 562): they import torch,
# which a Tune trial's process and a train worker whose function does not
# need it are spared.
STEP_NAMES = ("AdamW", "AdamWConstant", "AdamWState", "TrainState", "adamw",
              "default_optimizer", "make_eval_step", "make_train_state_factory",
              "make_train_step", "train_state_from_jax")


def __getattr__(name):
    if name in STEP_NAMES:
        from ray_tpu_torch.train import step

        return getattr(step, name)
    raise AttributeError(f"module 'ray_tpu_torch.train' has no attribute {name!r}")


__all__ = ["AdamW", "AdamWConstant", "AdamWState", "Checkpoint", "CheckpointConfig",
           "FailureConfig", "GpuTrainer", "Result", "RunConfig", "ScalingConfig", "TrainState",
           "adamw", "default_optimizer", "get_checkpoint", "get_context", "make_eval_step",
           "make_train_state_factory", "make_train_step", "report", "train_state_from_jax",
           "world_rank", "world_size"]
