"""Mixture-of-Experts with expert parallelism over the ``ep`` mesh axis (port
of ray_tpu/parallel/expert.py).

Capacity-based top-k routing (Switch/Mixtral style): tokens beyond an
expert's capacity are dropped (contribute zero), keeping shapes static.
The experts dimension carries the logical axis "expert" (-> ep). Under a
mesh the routing (top-k, buffer positions, the scatter-add dispatch and the
combine) runs on every rank over all tokens, as it is one cumulative sum
across them; the expert buffers and the batched SwiGLU are DTensors laid
out by the rules, so the expert products run sharded over ep (and fsdp, tp
for the weights' other dims).

Routing ties: ``jax.lax.top_k`` takes the lower expert index first among
equal probabilities; ``torch.topk`` does not promise an order, so the
experts are ranked by a stable descending sort, which does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import params_from_jax
from ray_tpu_torch.parallel.sharding import ShardingRules, shard_constraint


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


def moe_init(seed: int, config: MoeConfig, hidden: int, ffn: int,
             dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` (scaled normal,
    fan-in**-0.5, as the JAX package draws them; the numbers differ from
    JAX's, so parity tests convert JAX's with ``moe_params_from_jax``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    E = config.num_experts

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * fan_in ** -0.5).to(dtype)

    return {
        "router": normal((hidden, E), hidden).float(),
        "w_gate": normal((E, hidden, ffn), hidden),
        "w_up": normal((E, hidden, ffn), hidden),
        "w_down": normal((E, ffn, hidden), ffn),
    }


def moe_params_from_jax(tree, device="cpu") -> Dict[str, torch.Tensor]:
    """Carry JAX MoE weights ({router, w_gate, w_up, w_down}) across, bits
    copied exactly."""
    if set(tree) != {"router", "w_gate", "w_up", "w_down"}:
        raise ValueError(f"MoE weights have keys router, w_gate, w_up, w_down, got {sorted(tree)}")
    return params_from_jax(dict(tree), device)


def moe_logical_axes() -> Dict[str, Tuple]:
    return {
        "router": ("embed", None),
        "w_gate": ("expert", "embed", "mlp"),
        "w_up": ("expert", "embed", "mlp"),
        "w_down": ("expert", "mlp", "embed"),
    }


def _route(xf, router, E: int, K: int, capacity: int, jitter: float, rng):
    """Top-k routing and the dispatch buffers, over all N tokens: returns
    (dispatch [E, C, D], gate_idx [N, K], buffer position [N, K], gate
    weights [N, K] fp32 with the dropped ones zeroed, aux loss, dropped
    fraction)."""
    n_tokens, d = xf.shape
    logits = xf.float() @ router  # [N, E]
    if jitter and rng is not None:
        noise = torch.rand(logits.shape, generator=rng, device=logits.device)
        logits = logits + (noise * 2 - 1) * jitter
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :K]
    gate_vals = probs.gather(1, order)  # [N, K]
    gate_idx = order
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # position of each (token, k) in its expert's buffer; beyond capacity -> drop
    onehot = F.one_hot(gate_idx, E)  # [N, K, E] int64
    flat = onehot.reshape(n_tokens * K, E)
    positions = torch.cumsum(flat, dim=0) - flat  # [N*K, E]
    pos = (positions * flat).sum(-1).reshape(n_tokens, K)
    keep = pos < capacity

    token_ids = torch.arange(n_tokens, device=xf.device)[:, None].expand(n_tokens, K)
    rows = torch.where(keep.reshape(-1, 1), xf[token_ids.reshape(-1)],
                       torch.zeros((), dtype=xf.dtype, device=xf.device))
    dispatch = torch.zeros((E, capacity, d), dtype=xf.dtype, device=xf.device)
    dispatch = dispatch.index_put(
        (gate_idx.reshape(-1), torch.where(keep, pos, capacity - 1).reshape(-1)),
        rows, accumulate=True)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    denom = keep.sum().clamp(min=1).float()
    f = (onehot * keep[..., None]).sum((0, 1)).float() / denom
    aux_loss = E * (f * probs.mean(0)).sum()
    dropped = 1.0 - denom / (n_tokens * K)
    return dispatch, gate_idx, pos.clamp(0, capacity - 1), gate_vals * keep, aux_loss, dropped


def _combine(expert_out, gate_idx, pos, weights):
    """token t gets sum_k weight_k * expert_out[e_k, pos_k], in fp32."""
    n_tokens, K = gate_idx.shape
    gathered = expert_out[gate_idx.reshape(-1), pos.reshape(-1)].reshape(n_tokens, K, -1)
    return (gathered.float() * weights.float()[..., None]).sum(1)


def _experts(dispatch, params):
    """The batched SwiGLU: [E, C, D] x [E, D, F] -> [E, C, D]."""
    gate_act = F.silu(torch.einsum("ecd,edf->ecf", dispatch, params["w_gate"]))
    up = torch.einsum("ecd,edf->ecf", dispatch, params["w_up"])
    return torch.einsum("ecf,efd->ecd", gate_act * up, params["w_down"])


def moe_apply(
    params: Dict[str, Any],
    x: torch.Tensor,  # [B, S, D]
    config: MoeConfig,
    mesh=None,
    rules: Optional[ShardingRules] = None,
    rng: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (output [B,S,D], aux metrics incl. load-balance loss). Under a
    mesh (with rules) the weights are DTensors laid out by
    ``moe_logical_axes``, x is a DTensor or a tensor with the same global
    values on every rank, and the output is a replicated DTensor."""
    b, s, d = x.shape
    E, K = config.num_experts, config.top_k
    n_tokens = b * s
    capacity = max(1, int(n_tokens * K / E * config.capacity_factor))
    if mesh is None or rules is None:
        dispatch, gate_idx, pos, weights, aux_loss, dropped = _route(
            x.reshape(n_tokens, d), params["router"], E, K, capacity, config.router_jitter, rng)
        combined = _combine(_experts(dispatch, params), gate_idx, pos, weights)
        return combined.reshape(b, s, d).to(x.dtype), {
            "moe_aux_loss": aux_loss, "moe_dropped_fraction": dropped}

    rep = [Replicate()] * mesh.ndim
    xf = shard_constraint(x, mesh, rules, (None, None, None)).reshape(n_tokens, d)
    router = shard_constraint(params["router"], mesh, rules, (None, None))
    route = local_map(
        lambda xf, router: _route(xf, router, E, K, capacity, config.router_jitter, rng),
        out_placements=(rep,) * 6, in_placements=(rep, rep), device_mesh=mesh)
    dispatch, gate_idx, pos, weights, aux_loss, dropped = route(xf, router)
    dispatch = shard_constraint(dispatch, mesh, rules, ("expert", None, None))
    expert_out = _experts(dispatch, params)
    expert_out = shard_constraint(expert_out, mesh, rules, ("expert", None, None))
    # every rank combines all its tokens from the whole (gathered) buffers
    combine = local_map(_combine, out_placements=rep, in_placements=(rep,) * 4,
                        device_mesh=mesh)
    combined = combine(shard_constraint(expert_out, mesh, rules, (None, None, None)),
                       gate_idx, pos, weights)
    return combined.reshape(b, s, d).to(x.dtype), {
        "moe_aux_loss": aux_loss, "moe_dropped_fraction": dropped}
