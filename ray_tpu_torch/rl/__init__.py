from ray_tpu_torch.rl.grpo import (GRPOConfig, compute_group_advantages, grpo_loss,
                                   make_grpo_step, make_logprob_fn)
from ray_tpu_torch.rl.ppo import (PPOConfig, gae_advantages, init_value_head, make_ppo_step,
                                  ppo_loss, value_estimates, value_head_from_jax)
from ray_tpu_torch.rl.trainer import GRPOTrainer

__all__ = ["GRPOConfig", "GRPOTrainer", "PPOConfig", "compute_group_advantages",
           "gae_advantages", "grpo_loss", "init_value_head", "make_grpo_step",
           "make_logprob_fn", "make_ppo_step", "ppo_loss", "value_estimates",
           "value_head_from_jax"]
