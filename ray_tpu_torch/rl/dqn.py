"""DQN: double-Q learning over the env-runner/replay platform (the port of
ray_tpu.rl.dqn).

Reference capability: rllib/algorithms/dqn/ (double DQN per van Hasselt
'15, target network sync, prioritized replay, epsilon-greedy schedule).
The Q-network is a plain fp32 MLP (a list of ``{"w": [a, b], "b": [b]}``
layers, ``x @ w + b``, the JAX package's layout), the update is one
autograd pass (forward + huber TD loss) and one AdamW step
(``train.step.adamw``, the counterpart of ``optax.adamw``), and rollouts
come from a fault-tolerant EnvRunnerGroup with params broadcast through the
object store as CPU copies.

The learner's parameters, target and optimizer state live on ``device``
(None: the card; with no card present it raises). The env runners' greedy
policy runs on the same device, as the JAX package's runners run their
jitted forward on its default device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.env_runner import EnvRunnerGroup
from ray_tpu_torch.rl.replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from ray_tpu_torch.train.step import _leaves, adamw
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("rl.dqn")


@dataclass
class DQNConfig:
    env: str = "CartPole-rt"
    env_config: Dict[str, Any] = field(default_factory=dict)
    hidden: tuple = (128, 128)
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    prioritized: bool = True
    batch_size: int = 64
    num_runners: int = 2
    rollout_steps: int = 128       # per runner per iteration
    target_sync_interval: int = 8  # iterations between target syncs
    epsilon_start: float = 1.0
    epsilon_end: float = 0.05
    epsilon_decay_iters: int = 40
    learning_starts: int = 500     # min transitions before updates
    updates_per_iter: int = 32
    double_q: bool = True
    seed: int = 0


# ------------------------------------------------------------ param trees
def as_tree(params):
    """``params`` (lists and dicts of tensors) as nested dicts, lists keyed
    by their zero-padded index, sharing the tensors: the form
    ``train.step``'s optimizer walks (its ``_leaves`` order)."""
    if isinstance(params, (list, tuple)):
        return {f"{i:04d}": as_tree(v) for i, v in enumerate(params)}
    if isinstance(params, dict):
        return {k: as_tree(v) for k, v in params.items()}
    return params


def params_to(params, device, copy: bool = False):
    """The same tree with every tensor on ``device`` (a copy if ``copy``)."""
    if isinstance(params, (list, tuple)):
        return [params_to(v, device, copy) for v in params]
    if isinstance(params, dict):
        return {k: params_to(v, device, copy) for k, v in params.items()}
    return params.detach().to(device, copy=copy)


def params_from_numpy(tree, device):
    """A tree of arrays (numpy, or anything ``np.asarray`` takes: the JAX
    package's params) as fp32 tensors on ``device``, same layout. Always a
    copy: the updates write the parameters in place."""
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), dtype=torch.float32, device=device)


def _batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _value_and_grad(loss_fn, params, *args):
    """(loss, aux, grads in ``_leaves(as_tree(params))`` order)."""
    leaves = _leaves(as_tree(params))
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss, aux = loss_fn(params, *args)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), aux, list(grads)


# -------------------------------------------------------------- Q-network
def q_init(obs_dim: int, num_actions: int, hidden, seed: int = 0, device=None):
    """He-normal weights and zero biases, drawn on the CPU from a generator
    seeded with ``seed`` (so every device gets the same values), then moved
    to ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    sizes = (obs_dim,) + tuple(hidden) + (num_actions,)
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        params.append({
            "w": (torch.randn((a, b), generator=gen) * (2.0 / a) ** 0.5).to(dev),
            "b": torch.zeros((b,), device=dev),
        })
    return params


def q_params_from_jax(tree, device=None):
    """The JAX package's ``q_init`` list, converted (same layout)."""
    return params_from_numpy(tree, resolve_device(device))


def q_forward(params, obs):
    x = torch.as_tensor(obs, dtype=torch.float32).to(params[0]["w"].device)
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x  # [B, A]


def make_policy_builder(device=None):
    """Greedy-argmax policy used inside env runners (exploration noise is
    added runner-side; the network shape rides in via ``params``). The
    policy runs on ``device`` (None: the card) and moves the CPU params it
    is given there once for each params object, not once an env step."""
    dev = resolve_device(device)

    def builder():
        held: Dict[str, Any] = {}

        @torch.no_grad()
        def policy(params, obs_batch):
            if held.get("host") is not params:
                held["host"] = params  # kept alive, so `is` cannot match a new object
                held["params"] = params_to(params, dev)
            return q_forward(held["params"], obs_batch).argmax(-1).cpu().numpy()

        return policy

    return builder


def make_dqn_update(config: DQNConfig, optimizer):
    """``update(params, target_params, opt_state, batch) -> (params,
    opt_state, loss, td)``: the parameters and optimizer state are updated
    in place (and returned); ``batch`` holds numpy arrays or tensors."""

    def loss_fn(params, target_params, batch):
        q = q_forward(params, batch["obs"])  # [B, A]
        qa = q.gather(1, batch["actions"][:, None])[:, 0]
        with torch.no_grad():
            qn_target = q_forward(target_params, batch["next_obs"])
            if config.double_q:
                # action selection by the ONLINE net, evaluation by the target
                best = q_forward(params, batch["next_obs"]).argmax(-1)
                qn = qn_target.gather(1, best[:, None])[:, 0]
            else:
                qn = qn_target.max(-1).values
            target = batch["rewards"] + config.gamma * qn * (1.0 - batch["dones"])
        td = qa - target
        huber = torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5)
        w = batch.get("weights")
        loss = (huber * w).mean() if w is not None else huber.mean()
        return loss, td.detach()

    def update(params, target_params, opt_state, batch):
        batch = _batch_to(batch, params[0]["w"].device)
        loss, td, grads = _value_and_grad(loss_fn, params, target_params, batch)
        optimizer.update_(grads, opt_state, as_tree(params))
        return params, opt_state, loss, td

    return update


class DQNTrainer:
    """Iteration = sample rollouts -> fill buffer -> K updates -> (periodic)
    target sync. train() returns rllib-style result dicts."""

    def __init__(self, config: DQNConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        probe = make_env(config.env, **config.env_config)
        self.obs_dim = probe.obs_dim
        self.num_actions = probe.num_actions
        self.params = q_init(self.obs_dim, self.num_actions, config.hidden,
                             config.seed, self.device)
        self.target_params = params_to(self.params, self.device, copy=True)
        self.optimizer = adamw(config.lr)
        self.opt_state = self.optimizer.init(as_tree(self.params))
        self._update = make_dqn_update(config, self.optimizer)
        self.buffer = (PrioritizedReplayBuffer(config.buffer_capacity,
                                               seed=config.seed)
                       if config.prioritized
                       else ReplayBuffer(config.buffer_capacity,
                                         seed=config.seed))
        self.runners = EnvRunnerGroup(
            config.env,
            make_policy_builder(self.device),
            num_runners=config.num_runners, env_config=config.env_config,
            seed=config.seed,
        )
        self.iteration = 0
        self._episode_returns: List[float] = []

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self.iteration / max(1, c.epsilon_decay_iters))
        return c.epsilon_start + frac * (c.epsilon_end - c.epsilon_start)

    def train(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.perf_counter()
        params_ref = ray_tpu_torch.put(params_to(self.params, "cpu", copy=True))
        batches = self.runners.sample(params_ref, c.rollout_steps,
                                      explore=self._epsilon())
        steps = 0
        for b in batches:
            self.buffer.add_batch(b)
            steps += len(b["obs"])
            self._episode_returns.extend(
                e["episode_return"] for e in b["episodes"])
        losses = []
        if len(self.buffer) >= c.learning_starts:
            for _ in range(c.updates_per_iter):
                batch = self.buffer.sample(c.batch_size)
                dev = {k: v for k, v in batch.items() if k != "indices"}
                self.params, self.opt_state, loss, td = self._update(
                    self.params, self.target_params, self.opt_state, dev)
                losses.append(float(loss))
                if isinstance(self.buffer, PrioritizedReplayBuffer):
                    self.buffer.update_priorities(batch["indices"],
                                                  td.cpu().numpy())
        self.iteration += 1
        if self.iteration % c.target_sync_interval == 0:
            self.target_params = params_to(self.params, self.device, copy=True)
        recent = self._episode_returns[-20:]
        return {
            "training_iteration": self.iteration,
            "env_steps_this_iter": steps,
            "buffer_size": len(self.buffer),
            "epsilon": self._epsilon(),
            "loss": float(np.mean(losses)) if losses else None,
            "episode_return_mean": float(np.mean(recent)) if recent else None,
            "num_episodes": len(self._episode_returns),
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def stop(self) -> None:
        self.runners.stop()
