"""IMPALA: asynchronous off-policy actor-critic with V-trace correction
(the port of ray_tpu.rl.impala).

Reference capability: rllib/algorithms/impala/impala.py (Espeholt '18 —
actors stream trajectory unrolls ahead of the learner; the learner corrects
the resulting off-policyness with V-trace importance weighting). Redesign
on this runtime's primitives:

- each actor is a ``num_returns="streaming"`` remote GENERATOR
  (core/streaming.py): it rolls its env forever and yields fixed-length
  unrolls, with generator backpressure bounding how far a runner can run
  ahead of the learner — the queue the reference builds from aioqueues
  falls out of the streaming machinery;
- behavior-policy logits ride inside each unroll, so the learner computes
  clipped importance ratios against its CURRENT policy (V-trace rho/c);
- runners refresh params from the KV store every few unrolls (stale-policy
  lag is the point of IMPALA — V-trace absorbs it); the learner publishes
  them as CPU tensors, and a runner moves them to the learner's device;
- the update is one autograd pass over the [B, T] batch: forward, V-trace
  as a loop over T from the end (no gradient: the JAX package stops it on
  both outputs), policy-gradient + value + entropy losses, one AdamW step.

The learner's parameters and optimizer state live on ``device`` (None: the
card; with no card present it raises); the runners' forward runs on the
same device, one env step at a time, as the JAX package's runners do.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rl.dqn import _batch_to, _value_and_grad, as_tree, params_from_numpy, params_to
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.train.step import adamw
from ray_tpu_torch.utils.logging import get_logger

logger = get_logger("rl.impala")

PARAMS_KEY = "impala:params"


@dataclass
class ImpalaConfig:
    env: str = "CartPole-rt"
    env_config: Dict[str, Any] = field(default_factory=dict)
    hidden: tuple = (128, 128)
    lr: float = 5e-4
    gamma: float = 0.99
    unroll_len: int = 32           # T: steps per yielded trajectory piece
    num_runners: int = 2
    batch_unrolls: int = 8         # B: unrolls per learner update
    rho_clip: float = 1.0          # V-trace rho-bar (IS clip for deltas/pg)
    c_clip: float = 1.0            # V-trace c-bar (trace cutting)
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    param_refresh_unrolls: int = 1  # runner pulls params every N unrolls
    max_queue_unrolls: int = 8     # backpressure: max unrolls a runner runs ahead
    seed: int = 0


# ------------------------------------------------------------ actor-critic
def ac_init(obs_dim: int, num_actions: int, hidden, seed: int = 0, device=None):
    """The JAX package's ``{"trunk", "pi", "v"}`` layout: He-normal trunk,
    heads at 0.01 scale, zero biases; drawn on the CPU from a generator
    seeded with ``seed``, then moved to ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    sizes = (obs_dim,) + tuple(hidden)
    trunk = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        trunk.append({
            "w": (torch.randn((a, b), generator=gen) * (2.0 / a) ** 0.5).to(dev),
            "b": torch.zeros((b,), device=dev),
        })
    return {
        "trunk": trunk,
        "pi": {"w": (torch.randn((sizes[-1], num_actions), generator=gen) * 0.01).to(dev),
               "b": torch.zeros((num_actions,), device=dev)},
        "v": {"w": (torch.randn((sizes[-1], 1), generator=gen) * 0.01).to(dev),
              "b": torch.zeros((1,), device=dev)},
    }


def ac_params_from_jax(tree, device=None):
    """The JAX package's ``ac_init`` tree, converted (same layout)."""
    return params_from_numpy(tree, resolve_device(device))


def ac_forward(params, obs):
    """obs [..., obs_dim] -> (logits [..., A], value [...])."""
    x = torch.as_tensor(obs, dtype=torch.float32).to(params["pi"]["w"].device)
    for layer in params["trunk"]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["v"]["w"] + params["v"]["b"])[..., 0]
    return logits, value


# ----------------------------------------------------------------- V-trace
@torch.no_grad()
def vtrace(behavior_logp, target_logp, rewards, values, bootstrap, dones,
           gamma: float, rho_clip: float, c_clip: float):
    """All inputs [B, T] (bootstrap [B]). Returns (vs [B,T], pg_adv [B,T]),
    both without gradient.

    vs_t = V_t + sum_{k>=t} gamma^{k-t} (prod_{i<k} c_i) delta_k,
    delta_k = rho_k (r_k + gamma V_{k+1} (1-d_k) - V_k), accumulated in one
    loop over t from T-1 down to 0 (the JAX package's backward lax.scan).
    """
    ratio = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(ratio, max=rho_clip)
    c = torch.clamp(ratio, max=c_clip)
    not_done = 1.0 - dones
    v_next = torch.cat([values[:, 1:], bootstrap[:, None]], dim=1)
    deltas = rho * (rewards + gamma * v_next * not_done - values)
    vs_minus_v = torch.empty_like(values)
    acc = torch.zeros_like(bootstrap)
    for t in range(values.shape[1] - 1, -1, -1):
        acc = deltas[:, t] + gamma * not_done[:, t] * c[:, t] * acc
        vs_minus_v[:, t] = acc
    vs = values + vs_minus_v
    vs_next = torch.cat([vs[:, 1:], bootstrap[:, None]], dim=1)
    pg_adv = rho * (rewards + gamma * vs_next * not_done - values)
    return vs, pg_adv


def make_impala_update(config: ImpalaConfig, optimizer):
    """``update(params, opt_state, batch) -> (params, opt_state, loss,
    aux)``: the parameters and optimizer state are updated in place (and
    returned); ``batch`` holds numpy arrays or tensors."""

    def loss_fn(params, batch):
        # batch: obs [B,T,O], next_obs_last [B,O], actions [B,T],
        # rewards [B,T], dones [B,T], behavior_logits [B,T,A]
        logits, values = ac_forward(params, batch["obs"])
        with torch.no_grad():
            _, bootstrap = ac_forward(params, batch["next_obs_last"])
        logp_all = torch.log_softmax(logits, dim=-1)
        act = batch["actions"][..., None]
        target_logp = logp_all.gather(-1, act)[..., 0]
        behavior_logp = torch.log_softmax(batch["behavior_logits"], dim=-1).gather(-1, act)[..., 0]
        vs, pg_adv = vtrace(
            behavior_logp, target_logp.detach(), batch["rewards"], values.detach(),
            bootstrap, batch["dones"], config.gamma, config.rho_clip,
            config.c_clip,
        )
        pg_loss = -(target_logp * pg_adv).mean()
        v_loss = 0.5 * ((vs - values) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        loss = (pg_loss + config.value_coef * v_loss
                - config.entropy_coef * entropy)
        aux = {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy,
               "mean_rho": torch.exp(target_logp - behavior_logp).mean()}
        return loss, {k: v.detach() for k, v in aux.items()}

    def update(params, opt_state, batch):
        batch = _batch_to(batch, params["pi"]["w"].device)
        loss, aux, grads = _value_and_grad(loss_fn, params, batch)
        optimizer.update_(grads, opt_state, as_tree(params))
        return params, opt_state, loss, aux

    return update


# ---------------------------------------------------------- streaming actor
def _make_rollout_stream(config: ImpalaConfig, device=None):
    """Returns the streaming remote function: an infinite generator of
    unrolls whose policy forward runs on ``device`` (None: the card).
    Created per-trainer so backpressure rides the remote options."""
    dev = resolve_device(device)

    @ray_tpu_torch.remote(num_returns="streaming",
                          _generator_backpressure=config.max_queue_unrolls,
                          name="impala::rollout_stream")
    def rollout_stream(worker_index: int, num_unrolls: int):
        import cloudpickle

        env = make_env(config.env, **config.env_config)
        rng = np.random.default_rng(config.seed + worker_index)
        params = params_to(cloudpickle.loads(ray_tpu_torch.kv_get(PARAMS_KEY)), dev)
        obs, _ = env.reset(seed=config.seed + worker_index)
        ep_ret, ep_len, completed = 0.0, 0, []
        for unroll_idx in range(num_unrolls):
            if unroll_idx % config.param_refresh_unrolls == 0 and unroll_idx:
                raw = ray_tpu_torch.kv_get(PARAMS_KEY)
                if raw is not None:
                    params = params_to(cloudpickle.loads(raw), dev)
            T = config.unroll_len
            obs_l, act_l, rew_l, done_l, logits_l = [], [], [], [], []
            for _ in range(T):
                with torch.no_grad():
                    logits, _v = ac_forward(params, obs[None])
                logits = logits[0].cpu().numpy()
                # sample from the behavior policy (exploration comes from
                # the policy's own entropy, kept up by the entropy bonus)
                z = logits - logits.max()
                p = np.exp(z) / np.exp(z).sum()
                action = int(rng.choice(len(p), p=p))
                nxt, reward, terminated, truncated, _ = env.step(action)
                obs_l.append(obs)
                act_l.append(action)
                rew_l.append(reward)
                # truncations also cut the trace: the next stored obs is the
                # RESET state of a new episode, so bootstrapping across the
                # boundary would leak the wrong episode's value into V-trace
                # targets (slightly pessimistic near time limits, never biased
                # by cross-episode leakage)
                done_l.append(float(terminated or truncated))
                logits_l.append(logits)
                ep_ret += reward
                ep_len += 1
                if terminated or truncated:
                    completed.append({"episode_return": ep_ret,
                                      "episode_len": ep_len})
                    ep_ret, ep_len = 0.0, 0
                    obs, _ = env.reset()
                else:
                    obs = nxt
            episodes, completed = completed, []
            yield {
                "obs": np.asarray(obs_l, np.float32),
                "next_obs_last": np.asarray(obs, np.float32),
                "actions": np.asarray(act_l, np.int64),
                "rewards": np.asarray(rew_l, np.float32),
                "dones": np.asarray(done_l, np.float32),
                "behavior_logits": np.asarray(logits_l, np.float32),
                "episodes": episodes,
                "worker_index": worker_index,
            }

    return rollout_stream


class ImpalaTrainer:
    """Learner loop: consume unroll streams round-robin, batch them, run the
    V-trace update, publish fresh params to KV. train() returns rllib-style
    result dicts (+ env_steps_per_s, the IMPALA headline)."""

    def __init__(self, config: ImpalaConfig, total_unrolls_per_runner: int = 10_000,
                 device=None):
        import cloudpickle

        self.config = config
        self.device = resolve_device(device)
        probe = make_env(config.env, **config.env_config)
        self.params = ac_init(probe.obs_dim, probe.num_actions,
                              config.hidden, config.seed, self.device)
        self.optimizer = adamw(config.lr)
        self.opt_state = self.optimizer.init(as_tree(self.params))
        self._update = make_impala_update(config, self.optimizer)
        ray_tpu_torch.kv_put(PARAMS_KEY, cloudpickle.dumps(
            params_to(self.params, "cpu", copy=True)))
        stream_fn = _make_rollout_stream(config, self.device)
        self._streams = [
            iter(stream_fn.remote(i, total_unrolls_per_runner))
            for i in range(config.num_runners)
        ]
        self.iteration = 0
        self._episode_returns: List[float] = []
        self._env_steps = 0

    def _next_unrolls(self, n: int, timeout: float = 120.0) -> List[Dict]:
        """Round-robin pull across runner streams; a finished/failed stream
        is dropped (remaining runners keep the learner fed — the reference's
        aggregator keeps sampling through worker failures)."""
        out: List[Dict] = []
        while len(out) < n and self._streams:
            for it in list(self._streams):
                if len(out) >= n:
                    break
                try:
                    ref = next(it)
                    out.append(ray_tpu_torch.get(ref, timeout=timeout))
                except StopIteration:
                    self._streams.remove(it)
                except Exception:  # noqa: BLE001 - runner died mid-stream
                    logger.warning("dropping failed rollout stream",
                                   exc_info=True)
                    self._streams.remove(it)
        if not out:
            raise RuntimeError("all rollout streams ended")
        return out

    def train(self) -> Dict[str, Any]:
        import cloudpickle

        c = self.config
        t0 = time.perf_counter()
        unrolls = self._next_unrolls(c.batch_unrolls)
        batch = {
            k: np.stack([u[k] for u in unrolls])
            for k in ("obs", "next_obs_last", "actions", "rewards", "dones",
                      "behavior_logits")
        }
        for u in unrolls:
            self._episode_returns.extend(
                e["episode_return"] for e in u["episodes"])
            self._env_steps += len(u["actions"])
        self.params, self.opt_state, loss, aux = self._update(
            self.params, self.opt_state, batch)
        ray_tpu_torch.kv_put(PARAMS_KEY, cloudpickle.dumps(
            params_to(self.params, "cpu", copy=True)))
        self.iteration += 1
        dt = time.perf_counter() - t0
        recent = self._episode_returns[-20:]
        return {
            "training_iteration": self.iteration,
            "loss": float(loss),
            "pg_loss": float(aux["pg_loss"]),
            "v_loss": float(aux["v_loss"]),
            "entropy": float(aux["entropy"]),
            "mean_rho": float(aux["mean_rho"]),
            "env_steps_total": self._env_steps,
            "env_steps_this_iter": c.batch_unrolls * c.unroll_len,
            "env_steps_per_s": c.batch_unrolls * c.unroll_len / max(dt, 1e-9),
            "episode_return_mean": float(np.mean(recent)) if recent else None,
            "num_episodes": len(self._episode_returns),
            "time_this_iter_s": dt,
        }

    def stop(self) -> None:
        for it in self._streams:
            try:
                it.close()
            except Exception:  # noqa: BLE001
                pass
        self._streams = []
