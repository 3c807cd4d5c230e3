"""PPO for LLM policies: clipped surrogate + value head + GAE (port of
ray_tpu/rl/ppo.py).

The value function is a linear head on the SAME trunk (no second model);
GAE runs as a reverse loop over token positions, each iteration on the whole
batch at once; policy and value head update together, with one optimizer
and two optimizer states.

Under a ``mesh`` the policy is a tree of DTensors, as in ``rl/grpo.py``; the
value head stays plain tensors (the same on every rank), entering the
DTensor graph replicated, so its gradient comes back whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, llama_hidden, lm_head_weight, params_from_jax
from ray_tpu_torch.rl.grpo import shard_rows, token_logprobs
from ray_tpu_torch.train.step import (AdamW, AdamWState, TrainState, _leaves, _replicated,
                                      in_param_layout)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    clip_eps: float = 0.2
    value_clip: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.0
    gamma: float = 1.0
    lam: float = 0.95
    epochs_per_batch: int = 2


def init_value_head(config: LlamaConfig, generator: torch.Generator,
                    device=None) -> Dict[str, torch.Tensor]:
    """{"w": [H] fp32, scaled normal (fan-in**-0.5), "b": 0-d fp32 zero}, on
    ``device`` (the card unless "cpu"); ``generator`` lies on that device."""
    dev = resolve_device(device)
    h = config.hidden_size
    w = torch.randn((h,), generator=generator, dtype=torch.float32, device=dev) * h ** -0.5
    return {"w": w, "b": torch.zeros((), dtype=torch.float32, device=dev)}


def value_head_from_jax(value_head, device="cpu") -> Dict[str, torch.Tensor]:
    """Carry a JAX value head ({"w": [H], "b": []}, fp32) across, bits copied
    exactly."""
    if set(value_head) != {"w", "b"}:
        raise ValueError(f"a value head has keys w and b, got {sorted(value_head)}")
    return params_from_jax(dict(value_head), device)


def _replicated_head(value_head, mesh):
    """The plain value head as replicated DTensors under a mesh
    (differentiable: the gradient comes back to the plain tensors whole)."""
    if mesh is None:
        return value_head
    rep = [Replicate()] * mesh.ndim
    return {k: DTensor.from_local(v, mesh, rep, run_check=False) for k, v in value_head.items()}


def value_estimates(params, value_head, tokens, config: LlamaConfig, mesh=None) -> torch.Tensor:
    """Per-position value V(s_t) [B, T]: the linear head on the trunk's hidden
    states (a plain tensor under a mesh too)."""
    tokens = tokens.long()
    if mesh is not None:
        tokens, = shard_rows(mesh, tokens)
    x = llama_hidden(params, tokens, config, mesh=mesh)
    vh = _replicated_head(value_head, mesh)
    return _replicated(x.float() @ vh["w"] + vh["b"])


def gae_advantages(rewards, values, mask, gamma: float, lam: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized Advantage Estimation over token positions.

    rewards/values/mask: [B, T] fp32 (mask zeros out padding). Returns
    (advantages [B, T], returns [B, T]). The reverse recurrence runs over T,
    each step on all B rows at once."""
    b, t = rewards.shape
    zeros = rewards.new_zeros((b, 1))
    next_values = torch.cat([values[:, 1:], zeros], dim=1)
    # Bootstrap with the validity of position t+1, not t: the last unmasked
    # step must bootstrap from 0, not from V evaluated on padding.
    next_mask = torch.cat([mask[:, 1:], zeros], dim=1)
    deltas = (rewards + gamma * next_values * next_mask - values) * mask
    adv = torch.empty_like(deltas)
    carry = rewards.new_zeros(b)
    for i in reversed(range(t)):
        carry = deltas[:, i] + gamma * lam * mask[:, i] * carry
        adv[:, i] = carry
    advantages = adv * mask
    return advantages, advantages + values * mask


def ppo_loss(params, value_head, batch: Dict[str, Any], config: LlamaConfig, ppo: PPOConfig,
             mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    tokens = batch["tokens"].long()     # [B, T]
    mask = batch["mask"]                # [B, T-1] action positions
    old_logp = batch["old_logprobs"]    # [B, T-1]
    advantages = batch["advantages"]    # [B, T-1]
    returns = batch["returns"]          # [B, T-1]
    old_values = batch["old_values"]    # [B, T-1]
    if mesh is not None:
        tokens, mask, old_logp, advantages, returns, old_values = shard_rows(
            mesh, tokens, mask, old_logp, advantages, returns, old_values)

    x = llama_hidden(params, tokens, config, mesh=mesh)
    logp, logits = token_logprobs(x, lm_head_weight(params, config), tokens)
    vh = _replicated_head(value_head, mesh)
    values = x[:, :-1].float() @ vh["w"] + vh["b"]

    denom = mask.sum().clamp(min=1.0)
    # normalized advantages (standard PPO practice)
    amean = (advantages * mask).sum() / denom
    astd = torch.sqrt((((advantages - amean) * mask) ** 2).sum() / denom) + 1e-6
    adv = (advantages - amean) / astd

    ratio = torch.exp(logp - old_logp)
    pg = -(torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps) * adv
    ) * mask).sum() / denom

    v_clipped = old_values + torch.clamp(values - old_values, -ppo.value_clip, ppo.value_clip)
    v_loss = 0.5 * (torch.maximum((values - returns) ** 2, (v_clipped - returns) ** 2)
                    * mask).sum() / denom

    probs = torch.softmax(logits[:, :-1], dim=-1)
    plogp = probs * torch.where(probs > 0, torch.log(probs), torch.zeros_like(probs))
    entropy = -(plogp.sum(-1) * mask).sum() / denom

    loss = pg + ppo.value_coef * v_loss - ppo.entropy_coef * entropy
    return loss, {"pg_loss": pg, "value_loss": v_loss, "entropy": entropy}


def make_ppo_step(config: LlamaConfig, optimizer: AdamW, ppo: PPOConfig, mesh=None):
    """(state, value_head, vh_opt_state, batch) -> (state, value_head,
    vh_opt_state, metrics). Policy and value head take their gradients from
    one backward and their updates from the same optimizer, each with its own
    state, in place."""

    def step_fn(state: TrainState, value_head, vh_opt: AdamWState, batch):
        leaves, vleaves = _leaves(state.params), _leaves(value_head)
        for p in leaves + vleaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, aux = ppo_loss(state.params, value_head, batch, config, ppo, mesh=mesh)
            grads = list(torch.autograd.grad(loss, leaves + vleaves))
        optimizer.update_(in_param_layout(grads[:len(leaves)], leaves), state.opt_state,
                          state.params)
        optimizer.update_(grads[len(leaves):], vh_opt, value_head)
        new_state = TrainState(step=state.step + 1, params=state.params,
                               opt_state=state.opt_state)
        metrics = {"loss": _replicated(loss.detach()),
                   **{k: _replicated(v.detach()) for k, v in aux.items()}}
        return new_state, value_head, vh_opt, metrics

    return step_fn
