"""Train and eval steps (port of ray_tpu/train/step.py), on one device.

``default_optimizer`` is optax's
``chain(clip_by_global_norm(grad_clip), adamw(warmup_cosine_decay_schedule))``
written out in PyTorch, so that both frameworks take the same update from
the same state (``torch.optim.AdamW`` and ``clip_grad_norm_`` differ: the
latter divides by ``norm + 1e-6``, optax by ``norm``); ``adamw`` is plain
``optax.adamw(learning_rate)`` (a constant rate, no clipping, ``b2`` 0.999,
weight decay 1e-4), which drives the ViT (``models/vit.py``). Both run one
update loop (``AdamWConstant.update_``). ``default_optimizer`` adds:

- the schedule rises linearly from 0 to ``lr`` over ``warmup_steps``, then
  follows a cosine down to ``lr * 0.1`` at ``max(total_steps,
  warmup_steps + 1)``; it is read at the update count *before* the update,
  so update 0 runs at lr 0;
- clipping scales every gradient by ``grad_clip / g_norm`` only when
  ``g_norm >= grad_clip``.

Both:

- AdamW: ``b1``, ``b2``, ``eps`` 1e-8, ``eps_root`` 0, bias correction, then
  ``update = -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``; weight decay
  applies to every leaf, with no mask;
- the moments are kept in the parameters' dtype, as optax's
  ``scale_by_adam`` keeps them (``mu_dtype=None``).

The gradient norm is summed in fp32 (optax sums in the gradients' dtype; the
two agree in fp32). The metrics are ``loss``, ``grad_norm`` (of the
unclipped gradients) and ``step``. Parameters and moments are updated in
place, the counterpart of the JAX step's ``donate=True``.

Under a ``mesh`` the parameters and both moments are DTensors laid out by
``state_logical_axes`` (the moments take their parameter's axes), and each
gradient is redistributed to its parameter's placements before the update:
autograd hands it back in whatever layout its last op left (a parameter
placed (Shard on fsdp, Shard on tp) can come back (Partial, Replicate)).
The clip's norm is that of the whole gradients, DTensor reductions summing
across the shards. The metrics are plain tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ray_tpu_torch.models.llama import (LlamaConfig, cross_entropy_loss, llama_forward,
                                        llama_init, llama_logical_axes, llama_loss,
                                        params_from_jax)
from ray_tpu_torch.parallel.sharding import (DEFAULT_LLM_RULES, ShardingRules, shard_constraint,
                                             shard_pytree, sharding_pytree)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in a fixed (key-sorted) order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


@dataclasses.dataclass
class AdamWState:
    count: int  # updates applied so far (optax's ScaleByAdamState.count)
    mu: Dict[str, Any]
    nu: Dict[str, Any]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, Any]
    opt_state: AdamWState


EPS, EPS_ROOT = 1e-8, 0.0  # optax.adamw's defaults, which both optimizers keep


@dataclasses.dataclass(frozen=True)
class AdamWConstant:
    """``optax.adamw(lr, b1, b2, weight_decay=weight_decay)``: a constant
    learning rate, clipped to global norm ``grad_clip`` first unless it is
    None (optax.adamw alone does not clip)."""
    lr: float = 1e-3
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: Optional[float] = None

    def schedule(self, count: int) -> float:
        return self.lr

    def init(self, params) -> AdamWState:
        return AdamWState(count=0, mu=_zeros_like(params), nu=_zeros_like(params))

    @torch.no_grad()
    def update_(self, grads: List[torch.Tensor], state: AdamWState, params) -> torch.Tensor:
        """One update, in place on params and state. ``grads`` in the order of
        ``_leaves(params)``. Returns the global norm of the unclipped
        gradients (the step's ``grad_norm``)."""
        g_norm = global_norm(grads)
        clip = self.grad_clip is not None
        keep = g_norm < self.grad_clip if clip else None
        count = state.count + 1
        f32 = dict(dtype=torch.float32)
        bc1 = 1 - torch.tensor(self.b1, **f32) ** count
        bc2 = 1 - torch.tensor(self.b2, **f32) ** count
        step_size = torch.tensor(-self.schedule(state.count), **f32)
        for g, p, mu, nu in zip(grads, _leaves(params), _leaves(state.mu), _leaves(state.nu)):
            if clip:
                g = torch.where(keep, g, (g / g_norm.to(g.dtype)) * self.grad_clip)
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            mu_hat = mu / bc1.to(device=mu.device, dtype=mu.dtype)
            nu_hat = nu / bc2.to(device=nu.device, dtype=nu.dtype)
            u = mu_hat / (torch.sqrt(nu_hat + EPS_ROOT) + EPS)
            u = u + self.weight_decay * p
            p.add_(step_size.to(device=u.device, dtype=u.dtype) * u)
        state.count = count
        return g_norm


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          weight_decay: float = 1e-4) -> AdamWConstant:
    """The counterpart of ``optax.adamw(learning_rate, b1, b2,
    weight_decay=weight_decay)``, with optax's defaults."""
    return AdamWConstant(lr=learning_rate, weight_decay=weight_decay, b1=b1, b2=b2)


@dataclasses.dataclass(frozen=True)
class AdamW(AdamWConstant):
    """``default_optimizer``'s: the same update on the warmup-cosine schedule,
    after the global-norm clip."""
    lr: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000

    def schedule(self, count: int) -> float:
        """optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
        max(total_steps, warmup_steps + 1), end_value=lr * 0.1) at ``count``,
        in float32 with optax's own order of operations."""
        f32, lr = np.float32, self.lr
        if count < self.warmup_steps:
            frac = f32(1) - f32(count) / f32(self.warmup_steps)
            return float(f32(-lr) * frac + f32(lr))
        decay_steps = max(self.total_steps, self.warmup_steps + 1) - self.warmup_steps
        t = f32(min(count - self.warmup_steps, decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(decay_steps)))
        alpha = 0.1
        return float(f32(lr) * (f32(1 - alpha) * cosine + f32(alpha)))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def default_optimizer(lr: float = 3e-4, weight_decay: float = 0.1, b1: float = 0.9,
                      b2: float = 0.95, grad_clip: float = 1.0, warmup_steps: int = 100,
                      total_steps: int = 10000) -> AdamW:
    return AdamW(lr=lr, weight_decay=weight_decay, b1=b1, b2=b2, grad_clip=grad_clip,
                 warmup_steps=warmup_steps, total_steps=total_steps)


def state_logical_axes(config: LlamaConfig) -> TrainState:
    """Logical axes for the whole TrainState: the optimizer moments mirror
    the param axes; the step and the update count carry none."""
    axes = llama_logical_axes(config)
    return TrainState(step=None, params=axes, opt_state=AdamWState(count=None, mu=axes, nu=axes))


def _state_shardings(axes_tree, mesh, rules: ShardingRules):
    """The placements of every tensor of a TrainState's axes tree."""
    return sharding_pytree(axes_tree, mesh, rules)


def shard_train_state(state: TrainState, mesh, rules: ShardingRules = DEFAULT_LLM_RULES
                      ) -> TrainState:
    """Place a TrainState (from ``make_train_state_factory`` without a mesh
    or ``train_state_from_jax``; the same values on every rank) on ``mesh``:
    parameters and moments become DTensors laid out by
    ``state_logical_axes``, each rank keeping its shard."""
    config = LlamaConfig(tie_embeddings="lm_head" not in state.params)
    return shard_pytree(state, state_logical_axes(config), mesh, rules)


def _replicated(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def in_param_layout(grads, leaves):
    """Each gradient in its parameter's placements (a no-op off a mesh):
    autograd hands a DTensor gradient back in whatever layout its last op
    left, and the in-place update needs the parameter's own."""
    return [g.redistribute(p.device_mesh, p.placements) if isinstance(p, DTensor) else g
            for g, p in zip(grads, leaves)]


def make_train_state_factory(config: LlamaConfig, optimizer: AdamW, mesh=None,
                             rules: ShardingRules = DEFAULT_LLM_RULES) -> Callable[..., TrainState]:
    """Returns init(seed=0, device=None) -> TrainState (on the card unless
    ``device="cpu"``; under a mesh, on the mesh's device type, placed by
    ``shard_train_state``: the same values as the unsharded init from the
    same seed)."""

    def init(seed: int = 0, device=None) -> TrainState:
        if mesh is not None and device is None:
            device = mesh.device_type
        params = llama_init(config, seed=seed, device=device)
        state = TrainState(step=0, params=params, opt_state=optimizer.init(params))
        return state if mesh is None else shard_train_state(state, mesh, rules)

    return init


def make_train_step(config: LlamaConfig, optimizer: AdamW, mesh=None,
                    rules: ShardingRules = DEFAULT_LLM_RULES):
    """(state, tokens, targets) -> (state, metrics). tokens/targets: [B, S]
    (under a mesh: DTensors, or the same global values on every rank). The
    returned state holds the same tensors, updated in place."""

    def step_fn(state: TrainState, tokens, targets) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = _leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = llama_loss(state.params, tokens.long(), targets.long(), config, mesh=mesh,
                              rules=rules)
            grads = list(torch.autograd.grad(loss, leaves))
        gnorm = optimizer.update_(in_param_layout(grads, leaves), state.opt_state, state.params)
        new_state = TrainState(step=state.step + 1, params=state.params,
                               opt_state=state.opt_state)
        return new_state, {"loss": _replicated(loss.detach()), "grad_norm": _replicated(gnorm),
                           "step": new_state.step}

    return step_fn


def make_eval_step(config: LlamaConfig, mesh=None, rules: ShardingRules = DEFAULT_LLM_RULES):
    """(params, tokens, targets) -> the mean CE loss (a plain scalar)."""

    @torch.no_grad()
    def eval_fn(params, tokens, targets):
        logits = llama_forward(params, tokens.long(), config, mesh=mesh, rules=rules)
        targets = targets.long()
        if mesh is not None:
            # the gold-logit gather takes each rank's whole vocabulary rows
            logits = shard_constraint(logits, mesh, rules, ("batch", "seq", None))
            targets = shard_constraint(targets, mesh, rules, ("batch", "seq"))
        return _replicated(cross_entropy_loss(logits, targets))

    return eval_fn


def _optax_states(state):
    """Every NamedTuple state inside a (nested) optax state."""
    if hasattr(state, "_fields"):
        yield state
    if isinstance(state, tuple):
        for s in state:
            yield from _optax_states(s)


def train_state_from_jax(jstate, device="cpu") -> TrainState:
    """Carry a JAX ``TrainState`` made with ``ray_tpu.train.step.default_optimizer``
    (step, params, optax state: the adam count, mu and nu, and the schedule's
    count) into the port's state, bits copied exactly."""
    states = list(_optax_states(jstate.opt_state))
    adam = [s for s in states if "mu" in s._fields and "nu" in s._fields]
    if len(adam) != 1:
        raise ValueError("expected exactly one adam state (count, mu, nu) in the optax state")
    counts = {int(np.asarray(s.count)) for s in states if "count" in s._fields}
    if len(counts) != 1:
        raise ValueError(f"the optax state's counts disagree: {sorted(counts)}")
    return TrainState(step=int(np.asarray(jstate.step)),
                      params=params_from_jax(jstate.params, device),
                      opt_state=AdamWState(count=counts.pop(),
                                           mu=params_from_jax(dict(adam[0].mu), device),
                                           nu=params_from_jax(dict(adam[0].nu), device)))
