from ray_tpu_torch.train.step import (AdamW, AdamWConstant, AdamWState, TrainState, adamw,
                                      default_optimizer, make_eval_step, make_train_state_factory,
                                      make_train_step, train_state_from_jax)

__all__ = ["AdamW", "AdamWConstant", "AdamWState", "TrainState", "adamw", "default_optimizer",
           "make_eval_step", "make_train_state_factory", "make_train_step",
           "train_state_from_jax"]
