"""Env-runner platform: distributed rollout collection with fault tolerance
(the port of ray_tpu.rl.env_runner).

Reference capability: rllib/env/env_runner_group.py (EnvRunnerGroup) +
rllib/utils/actor_manager.py (FaultTolerantActorManager — probe health,
restart dead workers, keep sampling through failures). Redesign: runners
are plain actors hosting a vectorized env loop; the group broadcasts policy
params through the object store (one put per sync, every runner reads the
same ref — the arena store makes this zero-copy on-node) and gathers sample
batches, restarting any runner whose actor died and resubmitting its share.

The params a runner receives are CPU data (the learner puts CPU copies, as
the JAX package puts ``jax.device_get`` ones); the policy that
``policy_builder()`` returns moves them to its own device, once for each
params object it is given, so once a ``sample`` call and not once an env
step (``dqn.make_policy_builder``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("rl.env_runner")


@ray_tpu_torch.remote
class EnvRunner:
    """One rollout worker: steps its env with an epsilon-greedy/sampled
    policy and returns transition batches (reference: single_agent_env_runner
    .py)."""

    def __init__(self, env_name: str, policy_builder: Callable,
                 env_config: Optional[Dict[str, Any]] = None,
                 worker_index: int = 0, seed: int = 0):
        self.env = make_env(env_name, **(env_config or {}))
        # policy_builder() -> callable(params, obs_batch) -> actions [B];
        # params are CPU data
        self.policy = policy_builder()
        self.worker_index = worker_index
        self.rng = np.random.default_rng(seed + worker_index)
        self._obs, _ = self.env.reset(seed=seed + worker_index)
        self._episode_return = 0.0
        self._episode_len = 0
        self._completed: List[Dict[str, float]] = []

    def sample(self, params, num_steps: int,
               explore: float = 0.0) -> Dict[str, Any]:
        """Collect num_steps transitions (episodes roll over)."""
        obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
        for _ in range(num_steps):
            if self.rng.random() < explore:
                action = int(self.rng.integers(self.env.num_actions))
            else:
                action = int(self.policy(params, self._obs[None])[0])
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            obs_l.append(self._obs)
            act_l.append(action)
            rew_l.append(reward)
            next_l.append(nxt)
            done_l.append(terminated)
            self._episode_return += reward
            self._episode_len += 1
            if terminated or truncated:
                self._completed.append({
                    "episode_return": self._episode_return,
                    "episode_len": self._episode_len,
                })
                self._episode_return = 0.0
                self._episode_len = 0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        episodes, self._completed = self._completed, []
        return {
            "obs": np.asarray(obs_l, np.float32),
            "actions": np.asarray(act_l, np.int64),
            "rewards": np.asarray(rew_l, np.float32),
            "next_obs": np.asarray(next_l, np.float32),
            "dones": np.asarray(done_l, np.float32),
            "episodes": episodes,
            "worker_index": self.worker_index,
        }

    def ping(self) -> str:
        return "ok"


class EnvRunnerGroup:
    """N EnvRunner actors with restart-on-failure sampling (reference:
    EnvRunnerGroup over FaultTolerantActorManager)."""

    def __init__(self, env_name: str, policy_builder: Callable,
                 num_runners: int = 2,
                 env_config: Optional[Dict[str, Any]] = None, seed: int = 0,
                 max_restarts: int = 3):
        self.env_name = env_name
        self.policy_builder = policy_builder
        self.env_config = env_config
        self.seed = seed
        self.max_restarts = max_restarts
        self._restarts = 0
        self._runners: List[Any] = [
            self._start(i) for i in range(num_runners)
        ]

    def _start(self, index: int):
        return EnvRunner.options(max_restarts=0).remote(
            self.env_name, self.policy_builder, self.env_config,
            worker_index=index, seed=self.seed,
        )

    def sample(self, params_ref, steps_per_runner: int,
               explore: float = 0.0,
               timeout: float = 120.0) -> List[Dict[str, Any]]:
        """One synchronous sampling round. A dead runner is restarted and
        its share re-collected (up to max_restarts per group lifetime)."""
        out: List[Dict[str, Any]] = []
        pending = list(range(len(self._runners)))
        while pending:
            refs = {i: self._runners[i].sample.remote(
                params_ref, steps_per_runner, explore) for i in pending}
            failed: List[int] = []
            for i, ref in refs.items():
                try:
                    out.append(ray_tpu_torch.get(ref, timeout=timeout))
                except Exception:  # noqa: BLE001 - actor death / timeout
                    failed.append(i)
            if not failed:
                break
            if self._restarts + len(failed) > self.max_restarts:
                raise RuntimeError(
                    f"env runners failed more than {self.max_restarts} times")
            for i in failed:
                logger.warning("restarting env runner %d", i)
                try:
                    ray_tpu_torch.kill(self._runners[i])
                except Exception:  # noqa: BLE001
                    pass
                self._runners[i] = self._start(i)
                self._restarts += 1
            pending = failed
        return out

    def stop(self) -> None:
        for r in self._runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001
                pass
