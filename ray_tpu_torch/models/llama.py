"""Llama-class decoder in PyTorch (port of ray_tpu/models/llama.py).

Keeps the JAX package's parameter layout so weights convert one to one:

- a plain dict of tensors, per-layer weights STACKED along a leading [L]
  axis under ``params["layers"]``;
- x @ W orientation (``wq`` is [L, H, nh*hd], ``lm_head`` is [H, V]), not
  ``nn.Linear``'s transposed layout;
- ``tie_embeddings`` drops ``lm_head`` and reuses ``embed_tokens.T``.

bf16 weights and activations, fp32 RMSNorm statistics and logits.
Rematerialization (``LlamaConfig.remat``) maps the JAX package's modes onto
``torch.utils.checkpoint`` (non-reentrant): ``"full"`` and
``"nothing_saveable"`` recompute the whole layer in the backward,
``"mlp_only"`` only its MLP, and ``"save_attn"`` everything but the flash
op's outputs (out and lse), which selective checkpointing pins, so the
backward never re-runs the attention forward. No mesh yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import FLASH_ATTN_OP, attention
from ray_tpu_torch.ops.loss import fused_cross_entropy
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16
    remat: Optional[str] = "nothing_saveable"
    attention_impl: str = "auto"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def num_params(self) -> int:
        h, f, v = self.hidden_size, self.intermediate_size, self.vocab_size
        hd = self.head_dim_
        attn = h * (self.num_heads * hd) * 2 + h * (self.num_kv_heads * hd) * 2
        mlp = 3 * h * f
        per_layer = attn + mlp + 2 * h
        embed = v * h * (1 if self.tie_embeddings else 2)
        return self.num_layers * per_layer + embed + h

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                   num_layers=32, num_heads=32, num_kv_heads=8, **kw)

    @classmethod
    def llama_1b(cls, **kw) -> "LlamaConfig":
        return cls(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                   num_layers=22, num_heads=16, num_kv_heads=4, **kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        kw.setdefault("max_seq_len", 512)
        kw.setdefault("rope_theta", 10000.0)
        return cls(vocab_size=256, hidden_size=128, intermediate_size=256,
                   num_layers=2, num_heads=4, num_kv_heads=2, **kw)


def llama_init(config: LlamaConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device``
    (scaled normal, fan-in**-0.5, as the JAX package draws them; the numbers
    differ from JAX's, so parity tests convert JAX's with params_from_jax)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, hd = config.hidden_size, config.head_dim_
    nh, nkv = config.num_heads, config.num_kv_heads
    f, L, dt = config.intermediate_size, config.num_layers, config.dtype

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * fan_in ** -0.5).to(dt)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    params = {
        "embed_tokens": normal((config.vocab_size, h), h),
        "layers": {
            "attn_norm": ones((L, h)),
            "wq": normal((L, h, nh * hd), h),
            "wk": normal((L, h, nkv * hd), h),
            "wv": normal((L, h, nkv * hd), h),
            "wo": normal((L, nh * hd, h), nh * hd),
            "mlp_norm": ones((L, h)),
            "w_gate": normal((L, h, f), h),
            "w_up": normal((L, h, f), h),
            "w_down": normal((L, f, h), f),
        },
        "final_norm": ones((h,)),
    }
    if not config.tie_embeddings:
        params["lm_head"] = normal((h, config.vocab_size), h)
    return params


def _to_tensor(leaf) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes.bfloat16: copy the bits exactly
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_jax(tree, device="cpu") -> Dict[str, Any]:
    """Convert a JAX parameter pytree (nested dicts of arrays, as numpy or
    anything ``np.asarray`` takes) to the same nesting of tensors. Bits are
    copied exactly, bf16 and fp32 alike."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return _to_tensor(tree).to(device)


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer i's weights out of the stacked [L, ...] tensors (views)."""
    return {name: w[i] for name, w in params["layers"].items()}


def lm_head_weight(params: Dict[str, Any], config: LlamaConfig) -> torch.Tensor:
    head = params.get("lm_head")
    if head is None:
        head = params["embed_tokens"].T.to(config.dtype)
    return head


def _mlp(config: LlamaConfig, x, norm_w, w_gate, w_up, w_down):
    y = rms_norm(x, norm_w, config.rms_eps)
    return (torch.nn.functional.silu(y @ w_gate) * (y @ w_up)) @ w_down


def _layer(config: LlamaConfig, cos, sin, x, lp: Dict[str, torch.Tensor]):
    """One decoder layer. x: [B, S, H]; lp: per-layer params (no leading L)."""
    b, s, _ = x.shape
    nh, nkv, hd = config.num_heads, config.num_kv_heads, config.head_dim_
    y = rms_norm(x, lp["attn_norm"], config.rms_eps)
    q = apply_rope((y @ lp["wq"]).reshape(b, s, nh, hd), cos, sin)
    k = apply_rope((y @ lp["wk"]).reshape(b, s, nkv, hd), cos, sin)
    v = (y @ lp["wv"]).reshape(b, s, nkv, hd)
    o = attention(q, k, v, causal=True, impl=config.attention_impl)
    x = x + o.reshape(b, s, nh * hd) @ lp["wo"]
    mlp_args = (config, x, lp["mlp_norm"], lp["w_gate"], lp["w_up"], lp["w_down"])
    if config.remat == "mlp_only" and _records_grad(x, lp):
        # recompute only the MLP: its [B, S, F] intermediates are the bulk of
        # a layer's activations, and rebuilding them costs two matmuls
        return x + checkpoint(_mlp, *mlp_args, use_reentrant=False)
    return x + _mlp(*mlp_args)


def _records_grad(x, lp) -> bool:
    """Whether autograd records this layer (training): remat applies only then."""
    return torch.is_grad_enabled() and (x.requires_grad
                                        or any(w.requires_grad for w in lp.values()))


def _save_attn_policy(ctx, op, *args, **kwargs):
    if op == FLASH_ATTN_OP:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SAVE_ATTN_CONTEXTS = functools.partial(create_selective_checkpoint_contexts, _save_attn_policy)
REMAT_MODES = (None, "full", "nothing_saveable", "mlp_only", "save_attn")


def _run_layer(config: LlamaConfig, cos, sin, x, lp):
    if config.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {config.remat!r}; options: {REMAT_MODES}")
    remat = config.remat if _records_grad(x, lp) else None
    if remat in ("full", "nothing_saveable"):
        return checkpoint(_layer, config, cos, sin, x, lp, use_reentrant=False)
    if remat == "save_attn":
        return checkpoint(_layer, config, cos, sin, x, lp, use_reentrant=False,
                          context_fn=_SAVE_ATTN_CONTEXTS)
    return _layer(config, cos, sin, x, lp)


def llama_hidden(params: Dict[str, Any], tokens, config: LlamaConfig):
    """tokens: [B, S] integer -> final-norm hidden states [B, S, H]."""
    _, s = tokens.shape
    cos, sin = rope_frequencies(config.head_dim_, s, config.rope_theta, device=tokens.device)
    x = params["embed_tokens"][tokens].to(config.dtype)
    # one unbind per stacked weight: its backward stacks the L layer
    # gradients once, where indexing layer by layer would add L full-size
    # zero-padded gradients
    names = list(params["layers"])
    per_layer = zip(*(params["layers"][n].unbind(0) for n in names))
    for weights in per_layer:
        x = _run_layer(config, cos, sin, x, dict(zip(names, weights)))
    return rms_norm(x, params["final_norm"], config.rms_eps)


def llama_forward(params: Dict[str, Any], tokens, config: LlamaConfig):
    """tokens: [B, S] integer -> logits [B, S, vocab] (fp32)."""
    x = llama_hidden(params, tokens, config)
    return (x @ lm_head_weight(params, config)).float()


def llama_loss(params: Dict[str, Any], tokens, targets, config: LlamaConfig, mask=None):
    """Train loss through the fused, sequence-chunked LM head + CE
    (ops/loss.py): the [B, S, V] logits are never held whole."""
    x = llama_hidden(params, tokens, config)
    return fused_cross_entropy(x, lm_head_weight(params, config), targets, mask)


def cross_entropy_loss(logits, targets, mask=None):
    """logits: [B, S, V] fp32; targets: [B, S] integer. Mean (masked mean) NLL."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
