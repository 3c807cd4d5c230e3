"""GRPO: Group Relative Policy Optimization for LLM RLHF (port of
ray_tpu/rl/grpo.py).

- advantages are group-relative: G completions per prompt, rewards
  normalized within the group, so there is no value network;
- the update (per-token logprobs, clipped surrogate, k3 KL penalty against
  the frozen reference policy, optimizer) runs through ``llama_hidden`` with
  autograd, then the port's ``AdamW.update_`` in place, as
  ``train/step.py:make_train_step`` does;
- rollouts come from the serving engine (``rl/trainer.py``), so training and
  inference share one decode path.

The logits are an fp32 product of the bf16 hidden states and head, as the
JAX package's ``preferred_element_type=float32``; the gold logit is a
``gather``, which gives the same value as the one-hot select-reduce the JAX
package uses for sharded vocabularies.

Under a ``mesh`` the policy is a tree of DTensors (``train.step.
shard_train_state``), the trunk runs as ``llama_hidden(..., mesh=mesh)`` does,
the batch's per-sequence tensors are split over the batch axes, and the
gather takes each rank's whole vocabulary rows. The rollouts stay
unsharded, as in the JAX package: the serving engine takes no mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from ray_tpu_torch.models.llama import LlamaConfig, llama_hidden, lm_head_weight
from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, shard_constraint
from ray_tpu_torch.train.step import AdamW, TrainState, _leaves, _replicated, in_param_layout


@dataclasses.dataclass(frozen=True)
class GRPOConfig:
    group_size: int = 4
    clip_eps: float = 0.2
    kl_coef: float = 0.02
    temperature: float = 1.0
    max_new_tokens: int = 64
    epochs_per_batch: int = 1


def compute_group_advantages(rewards: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """rewards: [num_prompts, group_size] -> advantages, same shape,
    normalized WITHIN each prompt's group (the GRPO baseline). The std is the
    population std, as ``jnp.std``."""
    mean = rewards.mean(dim=-1, keepdim=True)
    std = rewards.std(dim=-1, keepdim=True, correction=0)
    return (rewards - mean) / (std + eps)


def token_logprobs(x: torch.Tensor, head: torch.Tensor, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, H] final hidden states; head: [H, V]; tokens: [B, T].
    Returns (logprob of token t+1 given the prefix up to t [B, T-1], the fp32
    logits [B, T, V])."""
    logits = x.float() @ head.float()
    if isinstance(logits, DTensor):
        # the gold-logit gather takes whole vocabulary rows on each rank
        logits = logits.redistribute(logits.device_mesh, [
            p if p.is_shard() and p.dim < 2 else Replicate() for p in logits.placements])
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits[:, :-1].gather(-1, tokens[:, 1:, None].long())[..., 0]
    return gold - logz[:, :-1], logits


def shard_rows(mesh, *tensors):
    """Per-sequence tensors ([N, ...], the same on every rank) split over the
    batch axes, their other dims whole; None stays None."""
    return [None if t is None else
            shard_constraint(t, mesh, DEFAULT_LLM_RULES, ("batch",) + (None,) * (t.dim() - 1))
            for t in tensors]


def make_logprob_fn(config: LlamaConfig, mesh=None):
    """Returns logprobs(params, tokens) -> per-token logprob [B, T-1] of
    token t+1 given the prefix up to t, with no gradient (the flash forward
    without lse on the card); a plain tensor under a mesh too."""

    @torch.no_grad()
    def logprobs(params, tokens):
        tokens = tokens.long()
        if mesh is not None:
            tokens, = shard_rows(mesh, tokens)
        x = llama_hidden(params, tokens, config, mesh=mesh)
        return _replicated(token_logprobs(x, lm_head_weight(params, config), tokens)[0])

    return logprobs


def grpo_loss(
    params,
    tokens,           # [N, T] integer (prompt + completion, right-padded)
    completion_mask,  # [N, T-1] 1.0 where position t PREDICTS a completion token
    advantages,       # [N] group-relative advantage per sequence
    old_logprobs,     # [N, T-1] logprobs under the rollout policy
    ref_logprobs,     # [N, T-1] logprobs under the frozen reference policy
    config: LlamaConfig,
    clip_eps: float,
    kl_coef: float,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    tokens = tokens.long()
    if mesh is not None:
        tokens, completion_mask, advantages, old_logprobs, ref_logprobs = shard_rows(
            mesh, tokens, completion_mask, advantages, old_logprobs, ref_logprobs)
    x = llama_hidden(params, tokens, config, mesh=mesh)
    logp, _ = token_logprobs(x, lm_head_weight(params, config), tokens)

    ratio = torch.exp(logp - old_logprobs)
    adv = advantages[:, None]
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    denom = completion_mask.sum().clamp(min=1.0)
    pg_loss = -(torch.minimum(unclipped, clipped) * completion_mask).sum() / denom

    # k3 KL estimator (unbiased, positive): exp(r) - r - 1, r = ref - policy
    r = ref_logprobs - logp
    kl = ((torch.exp(r) - r - 1.0) * completion_mask).sum() / denom

    loss = pg_loss + kl_coef * kl
    return loss, {"pg_loss": pg_loss, "kl": kl,
                  "ratio_mean": (ratio * completion_mask).sum() / denom}


def make_grpo_step(config: LlamaConfig, optimizer: AdamW, grpo: GRPOConfig, mesh=None):
    """(state, batch) -> (state, metrics); batch = dict(tokens,
    completion_mask, advantages, old_logprobs, ref_logprobs). The returned
    state holds the same tensors, updated in place. Metrics (plain tensors):
    loss, pg_loss, kl, ratio_mean, step."""

    def step_fn(state: TrainState, batch: Dict[str, Any]) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = _leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, aux = grpo_loss(
                state.params, batch["tokens"], batch["completion_mask"],
                batch["advantages"], batch["old_logprobs"], batch["ref_logprobs"],
                config, grpo.clip_eps, grpo.kl_coef, mesh=mesh)
            grads = list(torch.autograd.grad(loss, leaves))
        optimizer.update_(in_param_layout(grads, leaves), state.opt_state, state.params)
        new_state = TrainState(step=state.step + 1, params=state.params,
                               opt_state=state.opt_state)
        metrics = {"loss": _replicated(loss.detach()),
                   **{k: _replicated(v.detach()) for k, v in aux.items()},
                   "step": new_state.step}
        return new_state, metrics

    return step_fn
