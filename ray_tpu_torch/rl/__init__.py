from ray_tpu_torch.rl.dqn import DQNConfig, DQNTrainer, q_params_from_jax
from ray_tpu_torch.rl.env import CartPoleEnv, ChainEnv, make_env, register_env
from ray_tpu_torch.rl.env_runner import EnvRunner, EnvRunnerGroup
from ray_tpu_torch.rl.grpo import (GRPOConfig, compute_group_advantages, grpo_loss,
                                   make_grpo_step, make_logprob_fn)
from ray_tpu_torch.rl.impala import (ImpalaConfig, ImpalaTrainer, ac_forward, ac_init,
                                     ac_params_from_jax, vtrace)
from ray_tpu_torch.rl.ppo import (PPOConfig, gae_advantages, init_value_head, make_ppo_step,
                                  ppo_loss, value_estimates, value_head_from_jax)
from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.rl.trainer import GRPOTrainer

__all__ = ["CartPoleEnv", "ChainEnv", "DQNConfig", "DQNTrainer", "EnvRunner", "EnvRunnerGroup",
           "GRPOConfig", "GRPOTrainer", "ImpalaConfig", "ImpalaTrainer", "PPOConfig",
           "PrioritizedReplayBuffer", "ReplayBuffer", "ac_forward", "ac_init",
           "ac_params_from_jax", "compute_group_advantages", "gae_advantages", "grpo_loss",
           "init_value_head", "make_env", "make_grpo_step", "make_logprob_fn", "make_ppo_step",
           "ppo_loss", "q_params_from_jax", "register_env", "value_estimates",
           "value_head_from_jax", "vtrace"]
