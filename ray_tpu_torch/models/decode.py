"""KV-cached inference for the Llama family: prefill + batched decode.

Port of ray_tpu/models/decode.py (the dense, slotted cache):

- the KV cache is SLOTTED: a fixed [L, B_slots, S_max, H_kv, D] tensor; a
  request owns one slot for its lifetime;
- ``prefill`` runs the causal forward over a bucket-padded prompt and writes
  the slot's K/V rows; ``decode_one`` appends one token per slot and attends
  over the cache with a per-slot length mask;
- ``decode_steps`` runs T ticks, feeding each sampled token into the next.

Where JAX donates the cache buffers through ``jit`` so XLA updates them in
place, the port updates the cache tensors in place and returns them.
Where JAX clamps an out-of-range index silently, the port clamps it
explicitly: on the card an out-of-range index is a device-side assert.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, layer_params, lm_head_weight
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies


class KVCache(NamedTuple):
    k: torch.Tensor  # [L, B, S_max, H_kv, D]
    v: torch.Tensor  # [L, B, S_max, H_kv, D]


def init_kv_cache(config: LlamaConfig, num_slots: int, max_seq: int,
                  dtype=torch.bfloat16, device=None) -> KVCache:
    dev = resolve_device(device)
    shape = (config.num_layers, num_slots, max_seq, config.num_kv_heads,
             config.head_dim_)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))


def _project_qkv(config: LlamaConfig, lp: Dict[str, Any], x):
    """x: [B, T, H] -> q [B,T,nh,hd], k/v [B,T,nkv,hd] (pre-rope)."""
    b, t, _ = x.shape
    nh, nkv, hd = config.num_heads, config.num_kv_heads, config.head_dim_
    y = rms_norm(x, lp["attn_norm"], config.rms_eps)
    q = (y @ lp["wq"]).reshape(b, t, nh, hd)
    k = (y @ lp["wk"]).reshape(b, t, nkv, hd)
    v = (y @ lp["wv"]).reshape(b, t, nkv, hd)
    return y, q, k, v


def _mlp(config: LlamaConfig, lp: Dict[str, Any], x):
    y = rms_norm(x, lp["mlp_norm"], config.rms_eps)
    return (torch.nn.functional.silu(y @ lp["w_gate"]) * (y @ lp["w_up"])) @ lp["w_down"]


def _decode_attention(q, k_cache, v_cache, positions, scale):
    """q: [B, 1, nh, hd]; caches: [B, S, nkv, hd]; positions: [B] (index of
    the CURRENT token, already written into the cache). Attends over
    cache[: pos] inclusive. GQA through a grouped einsum, never a repeat of
    the cache; products in fp32."""
    b, _, nh, hd = q.shape
    s, nkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, nkv, nh // nkv, hd)
    logits = torch.einsum("bnrd,bsnd->bnrs", qg.float(), k_cache.float()) * scale
    mask = torch.arange(s, device=q.device)[None, :] <= positions[:, None]  # [B, S]
    logits = torch.where(mask[:, None, None, :], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnrs,bsnd->bnrd", probs.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, nh, hd).to(q.dtype)


def _write_cache_rows_full(cache_full, rows, positions, layer: int):
    """cache_full: [L, B, S, nkv, hd]; rows: [B, 1, nkv, hd]; positions: [B].
    Writes each slot's new row in place, at its position clamped into the
    cache as JAX's dynamic_update_slice clamps it."""
    b = rows.shape[0]
    pos = positions.long().clamp(0, cache_full.shape[2] - 1)
    cache_full[layer, torch.arange(b, device=rows.device), pos] = rows[:, 0].to(cache_full.dtype)
    return cache_full


def _embed(params, tokens, dtype):
    return params["embed_tokens"][tokens].to(dtype)


def _lm_head(params, x, config: LlamaConfig):
    x = rms_norm(x, params["final_norm"], config.rms_eps)
    return (x @ lm_head_weight(params, config)).float()


# --------------------------------------------------------------------------- #
# Prefill
# --------------------------------------------------------------------------- #
@torch.inference_mode()
def prefill(params, cache: KVCache, tokens, slot: int, length: int,
            config: LlamaConfig) -> Tuple[torch.Tensor, KVCache]:
    """tokens: [1, S_bucket] (padded); slot, length: ints (true prompt
    length). Runs the causal forward, writes K/V rows [0, S_bucket) of the
    slot in place, returns the logits at position length-1 ([V])."""
    _, s = tokens.shape
    cos, sin = rope_frequencies(config.head_dim_, s, config.rope_theta, device=tokens.device)
    x = _embed(params, tokens, config.dtype)
    for layer in range(config.num_layers):
        lp = layer_params(params, layer)
        _, q, k, v = _project_qkv(config, lp, x)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = attention(q, k, v, causal=True, impl=config.attention_impl)
        b, t, nh, hd = q.shape
        x = x + o.reshape(b, t, nh * hd) @ lp["wo"]
        x = x + _mlp(config, lp, x)
        cache.k[layer, slot, :s] = k[0].to(cache.k.dtype)
        cache.v[layer, slot, :s] = v[0].to(cache.v.dtype)
    # the head runs on the one row that is returned (rms_norm and the head
    # matmul are per row, so this is the same function as slicing after)
    last = min(max(int(length), 1), s) - 1
    return _lm_head(params, x[:, last], config)[0], cache


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
@torch.inference_mode()
def decode_one(params, cache: KVCache, tokens, positions,
               config: LlamaConfig) -> Tuple[torch.Tensor, KVCache]:
    """One decode tick for every slot. tokens: [B] (current input token per
    slot); positions: [B] (cache index to write this token's K/V). Returns
    (logits [B, V], cache updated in place)."""
    scale = config.head_dim_ ** -0.5
    cos, sin = rope_frequencies(config.head_dim_, int(cache.k.shape[2]),
                                config.rope_theta, device=tokens.device)
    x = _embed(params, tokens[:, None], config.dtype)  # [B, 1, H]
    for layer in range(config.num_layers):
        lp = layer_params(params, layer)
        _, q, k, v = _project_qkv(config, lp, x)
        q = apply_rope(q, cos, sin, positions=positions[:, None])
        k = apply_rope(k, cos, sin, positions=positions[:, None])
        _write_cache_rows_full(cache.k, k, positions, layer)
        _write_cache_rows_full(cache.v, v, positions, layer)
        o = _decode_attention(q, cache.k[layer], cache.v[layer], positions, scale)
        b, t, nh, hd = q.shape
        x = x + o.reshape(b, t, nh * hd) @ lp["wo"]
        x = x + _mlp(config, lp, x)
    return _lm_head(params, x, config)[:, 0], cache


def sample_token(logits, generator: Optional[torch.Generator], temperature: float):
    """logits: [B, V]. temperature <= 0 -> greedy; else a categorical draw
    through ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@torch.inference_mode()
def decode_steps(params, cache: KVCache, tokens, positions, active,
                 generator: Optional[torch.Generator], config: LlamaConfig,
                 num_steps: int, temperature: float = 0.0):
    """T decode ticks. tokens/positions/active: [B]; returns (sampled [B, T],
    last_tokens [B], new_positions [B], cache). Inactive slots still flow
    through the math, but their position does not advance, so their writes
    land on their own frozen row."""
    toks, pos = tokens, positions
    out = []
    for _ in range(num_steps):
        logits, cache = decode_one(params, cache, toks, pos, config)
        nxt = sample_token(logits, generator, temperature)
        toks = torch.where(active, nxt, toks)
        pos = torch.where(active, pos + 1, pos)
        out.append(toks)
    return torch.stack(out, dim=1), toks, pos, cache


def make_decode_fn(config: LlamaConfig, num_steps: int, temperature: float = 0.0):
    """Multi-step decode, cache updated in place (the JAX version donates)."""
    return functools.partial(decode_steps, config=config, num_steps=num_steps,
                             temperature=temperature)


def make_prefill_fn(config: LlamaConfig):
    return functools.partial(prefill, config=config)
