"""GRPOTrainer: rollout -> reward -> group advantage -> update loop (port of
ray_tpu/rl/trainer.py's GRPOTrainer).

Rollouts run on the serving engine (``serve/llm.py:LLMEngine``, the same
decode path production serving uses), one blocking ``generate`` at a time,
in the JAX package's order, so the sampled stream is reproducible from the
engine's seeded generator. The learner is ``make_grpo_step``.

The engine serves the trainer's own parameter tensors, which the update
writes in place: its loop thread only reads them while a ``generate`` is
outstanding, and the update runs only once every ``generate`` of the
rollout has returned. The frozen reference policy is a CLONE: an alias would
move with the policy, and the KL would read 0 forever.

With a ``mesh`` the learner (logprobs and update) runs sharded: the policy
and the reference policy are DTensors (``shard_train_state``), and after
each update the engine serves the whole updated policy (``full_tensor``
of each parameter); the rollouts stay unsharded, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, llama_init, llama_logical_axes
from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, shard_pytree
from ray_tpu_torch.rl.grpo import (GRPOConfig, compute_group_advantages, make_grpo_step,
                                   make_logprob_fn)
from ray_tpu_torch.serve.llm import LLMEngine, _params_to
from ray_tpu_torch.train.step import (TrainState, _replicated, default_optimizer,
                                      shard_train_state)

# A rollout request that has not returned after this long has failed: the
# engine loop logs and survives a failing kernel, so without a limit the
# trainer would wait forever.
ROLLOUT_TIMEOUT_S = 600.0


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _whole(tree):
    """The parameters as plain tensors: DTensors gathered, tensors as they are."""
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return _replicated(tree.detach())


class GRPOTrainer:
    """reward_fn(prompt_tokens, completion_tokens) -> float. Runs on
    ``device`` (the card unless "cpu")."""

    def __init__(
        self,
        config: LlamaConfig,
        reward_fn: Callable[[List[int], List[int]], float],
        grpo: Optional[GRPOConfig] = None,
        optimizer=None,
        params=None,
        num_slots: int = 8,
        device=None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.config = config
        self.grpo = grpo or GRPOConfig()
        self.reward_fn = reward_fn
        optimizer = optimizer or default_optimizer(lr=1e-5, warmup_steps=1,
                                                   total_steps=10_000)
        self._optimizer = optimizer
        params = (_params_to(params, self.device) if params is not None
                  else llama_init(config, 0, self.device))
        self.state = TrainState(step=0, params=params, opt_state=optimizer.init(params))
        # frozen reference policy for the KL penalty
        self._ref_params = _clone(params)
        if mesh is not None:
            self.state = shard_train_state(self.state, mesh)
            self._ref_params = shard_pytree(self._ref_params, llama_logical_axes(config), mesh,
                                            DEFAULT_LLM_RULES)
        self._logprob = make_logprob_fn(config, mesh=mesh)
        self._step = make_grpo_step(config, optimizer, self.grpo, mesh=mesh)
        self.engine = LLMEngine(
            config, params=params, device=self.device, num_slots=num_slots,
            temperature=self.grpo.temperature,
        )

    # ------------------------------------------------------------- rollouts
    def _rollout(self, prompts: Sequence[List[int]]):
        """G completions per prompt via the continuous-batching engine."""
        G = self.grpo.group_size
        outs: List[List[int]] = []
        metas: List[Dict[str, Any]] = []
        for p in prompts:
            for _ in range(G):
                r = self.engine.generate(list(p), max_tokens=self.grpo.max_new_tokens,
                                         timeout=ROLLOUT_TIMEOUT_S)
                outs.append(r["tokens"])
                metas.append({"prompt_len": len(p)})
        return outs, metas

    def train_step(self, prompts: Sequence[List[int]]) -> Dict[str, Any]:
        G = self.grpo.group_size
        dev = self.device
        completions, metas = self._rollout(prompts)
        rewards = np.asarray([
            self.reward_fn(list(p), c)
            for p, group in zip(prompts, _chunks(completions, G))
            for c in group
        ], np.float32).reshape(len(prompts), G)
        advantages = compute_group_advantages(torch.from_numpy(rewards)).numpy()

        # pack sequences: [prompt + completion], right-padded
        seqs = [list(p) + c for p, group in zip(prompts, _chunks(completions, G))
                for c in group]
        T = max(len(s) for s in seqs)
        N = len(seqs)
        tokens = np.zeros((N, T), np.int32)
        comp_mask = np.zeros((N, T - 1), np.float32)
        for i, (s, meta) in enumerate(zip(seqs, metas)):
            tokens[i, :len(s)] = s
            # position t predicts token t+1: completion predictions start at
            # prompt_len-1 and stop before padding
            comp_mask[i, meta["prompt_len"] - 1:len(s) - 1] = 1.0

        tokens = torch.from_numpy(tokens).to(dev)
        comp_mask = torch.from_numpy(comp_mask).to(dev)
        old_logprobs = self._logprob(self.state.params, tokens)
        ref_logprobs = self._logprob(self._ref_params, tokens)
        batch = {
            "tokens": tokens,
            "completion_mask": comp_mask,
            "advantages": torch.from_numpy(advantages.reshape(-1)).to(dev),
            "old_logprobs": old_logprobs,
            "ref_logprobs": ref_logprobs,
        }
        metrics: Dict[str, Any] = {}
        for _ in range(self.grpo.epochs_per_batch):
            self.state, metrics = self._step(self.state, batch)
        # the engine serves the UPDATED policy for the next rollouts (the
        # same tensors, updated in place; under a mesh, the gathered policy)
        self.engine.params = (self.state.params if self.mesh is None
                              else _whole(self.state.params))
        out = {k: float(v) for k, v in metrics.items()}
        out["reward_mean"] = float(rewards.mean())
        out["reward_std"] = float(rewards.std())
        return out

    def stop(self) -> None:
        self.engine.stop()


def _chunks(xs: List[Any], n: int):
    for i in range(0, len(xs), n):
        yield xs[i:i + n]
