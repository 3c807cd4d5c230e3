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
backward never re-runs the attention forward.

Under a ``mesh`` (``parallel/mesh.py``) the weights are DTensors laid out by
``llama_logical_axes`` through a ``ShardingRules`` table, and the layer
constrains its activations where the JAX package's does, by
``shard_constraint`` (a DTensor redistribute); DTensor's sharding
propagation plays the part of GSPMD in between, except that with a sharded
sequence the products and norms run on each rank's shards (``local_map``,
the placements worked out from the operands', in the Megatron pattern). The attention runs on local
tensors inside ``local_map`` (batch and heads sharded, the sequence whole),
or as ring attention when the ``seq`` rule maps to a mesh axis of size > 1;
the embedding lookup and the loss (the fused CE) run on each rank's tokens
inside ``local_map``, with the whole table and head, and sum across the
data axes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import FLASH_ATTN_OP, attention
from ray_tpu_torch.ops.loss import fused_cross_entropy
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies
from ray_tpu_torch.parallel.mesh import axis_size
from ray_tpu_torch.parallel.sharding import (DEFAULT_LLM_RULES, ShardingRules, shard_constraint,
                                             shard_tensor)


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


def llama_logical_axes(config: LlamaConfig) -> Dict[str, Any]:
    """Tree of logical-axis tuples, parallel to the params tree. Leading
    'layers' axis on stacked per-layer weights."""
    axes = {
        "embed_tokens": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", "embed"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "mlp_norm": ("layers", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": ("embed",),
    }
    if not config.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


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


def params_to_jax(tree) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: the same nesting as numpy arrays
    in the stacked ``[L, ...]`` x @ W layout, bits copied exactly. bf16
    leaves become ``ml_dtypes.bfloat16`` arrays (numpy's bf16 type, which
    ``jnp.asarray`` takes and ``_to_tensor`` reads back). Serves the AdamW
    moments (``TrainState.opt_state.mu`` / ``nu``) too: the same nesting."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    t = tree.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError as e:
            raise ImportError("params_to_jax needs the ml_dtypes package for bf16 leaves "
                              "(numpy has no bfloat16 type of its own)") from e
        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer i's weights out of the stacked [L, ...] tensors (views)."""
    return {name: w[i] for name, w in params["layers"].items()}


def lm_head_weight(params: Dict[str, Any], config: LlamaConfig) -> torch.Tensor:
    head = params.get("lm_head")
    if head is None:
        head = params["embed_tokens"].T.to(config.dtype)
    return head


def _seq_split(x) -> bool:
    """Whether a DTensor's tokens are split past its first dim (a sharded
    sequence): torch 2.11's DTensor cannot flatten [B, S] for a product or
    for a norm's weight gradient then, so those run on local shards."""
    return isinstance(x, DTensor) and any(
        p.is_shard() and 0 < p.dim % x.ndim < x.ndim - 1 for p in x.placements)


def _matmul(x, w):
    """x [..., K] @ w [K, N]; DTensor's own product, except with a sharded
    sequence, where each rank multiplies its own shards inside ``local_map``,
    per mesh dim in the Megatron pattern: tokens split (w whole there, its
    gradient a partial sum), K split (row-parallel: the output a partial
    sum), N split (column-parallel: x's gradient a partial sum), or all
    whole."""
    if not _seq_split(x):
        return x @ w
    last = x.ndim - 1
    rows = []  # per mesh dim: x, w, out, x's gradient, w's gradient
    for px, pw in zip(x.placements, w.placements):
        if px.is_shard() and px.dim % x.ndim < last:
            rows.append((px, Replicate(), px, px, Partial()))
        elif px.is_shard():
            rows.append((px, Shard(0), Partial(), px, Shard(0)))
        elif pw.is_shard() and pw.dim % w.ndim == 1:
            rows.append((Replicate(), pw, Shard(last), Partial(), pw))
        else:
            rows.append((Replicate(),) * 5)
    xp, wp, outp, gx, gw = (list(c) for c in zip(*rows))
    mesh = x.device_mesh
    return local_map(torch.matmul, out_placements=outp, in_placements=(xp, wp),
                     in_grad_placements=(gx, gw), device_mesh=mesh)(
        shard_tensor(x, mesh, xp), shard_tensor(w, mesh, wp))


def _norm(x, w, eps: float):
    """rms_norm; with a sharded sequence on each rank's tokens with the whole
    weight (``local_map``), the weight's gradient a partial sum over them."""
    if not _seq_split(x):
        return rms_norm(x, w, eps)
    mesh = x.device_mesh
    xp = [p if p.is_shard() and p.dim % x.ndim < x.ndim - 1 else Replicate()
          for p in x.placements]
    rep = [Replicate()] * mesh.ndim
    return local_map(rms_norm, out_placements=xp, in_placements=(xp, rep, None),
                     in_grad_placements=(xp, _data_partial(xp), None), device_mesh=mesh)(
        shard_tensor(x, mesh, xp), shard_tensor(w, mesh, rep), eps)


def _mlp(config: LlamaConfig, x, norm_w, w_gate, w_up, w_down):
    y = _norm(x, norm_w, config.rms_eps)
    return _matmul(torch.nn.functional.silu(_matmul(y, w_gate)) * _matmul(y, w_up), w_down)


def _heads_factor(mesh, rules: ShardingRules, logical: str) -> int:
    n = 1
    axes = rules.lookup(logical)
    for a in (axes,) if isinstance(axes, str) else (axes or ()):
        n *= axis_size(mesh, a)
    return n


def _check_heads(config: LlamaConfig, mesh, rules: ShardingRules) -> None:
    """The q and kv heads must split over the mesh by one factor, so each
    rank keeps whole GQA groups for its attention."""
    hq, hkv = config.num_heads, config.num_kv_heads
    fq, fkv = _heads_factor(mesh, rules, "act_heads"), _heads_factor(mesh, rules, "act_kv_heads")
    if fq != fkv or hq % fq or hkv % fkv:
        raise ValueError(f"sharded attention splits Hq={hq} over {fq} and Hkv={hkv} over {fkv}: "
                         "both must divide by one factor, so each rank keeps whole GQA groups")


def _attention_dispatch(config: LlamaConfig, rules: ShardingRules, mesh, q, k, v):
    """Route attention by parallelism layout: with the sequence sharded over
    a >1-sized mesh axis, plain (flash) attention can't see the full
    sequence, so ring attention runs (K/V ring, O(S/cp) memory per rank).
    Otherwise the flash path, on each rank's batch and heads (``local_map``):
    the kernels take raw pointers, which a DTensor does not have. q and kv
    heads split by the same factor (``_check_heads``), so each rank keeps
    whole GQA groups."""
    if mesh is None:
        return attention(q, k, v, causal=True, impl=config.attention_impl)
    seq_axis = rules.lookup("seq")
    if isinstance(seq_axis, str) and axis_size(mesh, seq_axis) > 1:
        from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded

        return ring_attention_sharded(
            q, k, v, mesh, causal=True, axis_name=seq_axis,
            q_spec=rules.spec(("batch", "seq", "act_heads", "head_dim")),
            kv_spec=rules.spec(("batch", "seq", "act_kv_heads", "head_dim")))
    q_pl = rules.placements(mesh, ("batch", None, "act_heads", "head_dim"))
    kv_pl = rules.placements(mesh, ("batch", None, "act_kv_heads", "head_dim"))
    q, k, v = shard_tensor(q, mesh, q_pl), shard_tensor(k, mesh, kv_pl), shard_tensor(v, mesh, kv_pl)
    local = local_map(lambda q, k, v: attention(q, k, v, causal=True, impl=config.attention_impl),
                      out_placements=list(q_pl), in_placements=(q_pl, kv_pl, kv_pl),
                      device_mesh=mesh)
    return local(q, k, v)


def _layer(config: LlamaConfig, rules: ShardingRules, mesh, cos, sin, x,
           lp: Dict[str, torch.Tensor]):
    """One decoder layer. x: [B, S, H]; lp: per-layer params (no leading L)."""
    b, s, _ = x.shape
    nh, nkv, hd = config.num_heads, config.num_kv_heads, config.head_dim_

    def cstr(t, axes):
        return t if mesh is None else shard_constraint(t, mesh, rules, axes)

    y = _norm(x, lp["attn_norm"], config.rms_eps)
    q = cstr(_matmul(y, lp["wq"]).reshape(b, s, nh, hd), ("batch", "seq", "act_heads", "head_dim"))
    k = cstr(_matmul(y, lp["wk"]).reshape(b, s, nkv, hd),
             ("batch", "seq", "act_kv_heads", "head_dim"))
    v = _matmul(y, lp["wv"]).reshape(b, s, nkv, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = _attention_dispatch(config, rules, mesh, q, k, v)
    x = x + cstr(_matmul(o.reshape(b, s, nh * hd), lp["wo"]), ("batch", "seq", "act_embed"))
    mlp_args = (config, x, lp["mlp_norm"], lp["w_gate"], lp["w_up"], lp["w_down"])
    if config.remat == "mlp_only" and _records_grad(x, lp):
        # recompute only the MLP: its [B, S, F] intermediates are the bulk of
        # a layer's activations, and rebuilding them costs two matmuls
        return x + cstr(checkpoint(_mlp, *mlp_args, use_reentrant=False),
                        ("batch", "seq", "act_embed"))
    return x + cstr(_mlp(*mlp_args), ("batch", "seq", "act_embed"))


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


def _run_layer(config: LlamaConfig, rules: ShardingRules, mesh, cos, sin, x, lp):
    if config.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {config.remat!r}; options: {REMAT_MODES}")
    remat = config.remat if _records_grad(x, lp) else None
    args = (config, rules, mesh, cos, sin, x, lp)
    if remat in ("full", "nothing_saveable"):
        return checkpoint(_layer, *args, use_reentrant=False)
    if remat == "save_attn":
        return checkpoint(_layer, *args, use_reentrant=False, context_fn=_SAVE_ATTN_CONTEXTS)
    return _layer(*args)


def llama_hidden(params: Dict[str, Any], tokens, config: LlamaConfig, mesh=None,
                 rules: ShardingRules = DEFAULT_LLM_RULES):
    """tokens: [B, S] integer -> final-norm hidden states [B, S, H]. Under a
    mesh, tokens is a DTensor or a tensor with the same global values on
    every rank, and the result is a DTensor."""
    _, s = tokens.shape
    cos, sin = rope_frequencies(config.head_dim_, s, config.rope_theta, device=tokens.device)
    if mesh is None:
        x = params["embed_tokens"][tokens].to(config.dtype)
    else:
        _check_heads(config, mesh, rules)
        rep = [Replicate()] * mesh.ndim
        cos, sin = (DTensor.from_local(t, mesh, rep, run_check=False) for t in (cos, sin))
        x = _sharded_embedding(params["embed_tokens"], tokens, mesh, rules).to(config.dtype)
    # one unbind per stacked weight: its backward stacks the L layer
    # gradients once, where indexing layer by layer would add L full-size
    # zero-padded gradients
    names = list(params["layers"])
    per_layer = zip(*(params["layers"][n].unbind(0) for n in names))
    for weights in per_layer:
        x = _run_layer(config, rules, mesh, cos, sin, x, dict(zip(names, weights)))
    return _norm(x, params["final_norm"], config.rms_eps)


def llama_forward(params: Dict[str, Any], tokens, config: LlamaConfig, mesh=None,
                  rules: ShardingRules = DEFAULT_LLM_RULES):
    """tokens: [B, S] integer -> logits [B, S, vocab] (fp32)."""
    x = llama_hidden(params, tokens, config, mesh=mesh, rules=rules)
    logits = _matmul(x, lm_head_weight(params, config)).float()
    if mesh is not None:
        logits = shard_constraint(logits, mesh, rules, ("batch", "seq", "act_vocab"))
    return logits


def llama_loss(params: Dict[str, Any], tokens, targets, config: LlamaConfig, mesh=None,
               rules: ShardingRules = DEFAULT_LLM_RULES, mask=None):
    """Train loss through the fused, sequence-chunked LM head + CE
    (ops/loss.py): the [B, S, V] logits are never held whole. Under a mesh
    it is a replicated DTensor scalar."""
    x = llama_hidden(params, tokens, config, mesh=mesh, rules=rules)
    head = lm_head_weight(params, config)
    if mesh is None:
        return fused_cross_entropy(x, head, targets, mask)
    return _sharded_cross_entropy(x, head, targets, mask, mesh, rules)


def _data_partial(placements):
    """Partial(sum) on the mesh dims that split a tensor's tokens, Replicate
    elsewhere: the layout of a weight's gradient from each rank's tokens."""
    return [Partial() if p.is_shard() else Replicate() for p in placements]


def _sharded_embedding(table, tokens, mesh, rules: ShardingRules):
    """Each rank looks its tokens up in the whole table (gathered), inside
    ``local_map``; the table's gradient is each rank's partial sum. (The JAX
    package uses a one-hot product, which GSPMD partitions; DTensor's own
    gather backward fails in torch 2.11.)"""
    tok = rules.placements(mesh, ("batch", "seq"))
    act = rules.placements(mesh, ("batch", "seq", "act_embed"))
    rep = [Replicate()] * mesh.ndim
    table, tokens = shard_tensor(table, mesh, rep), shard_tensor(tokens, mesh, tok)
    return local_map(lambda t, i: t[i], out_placements=list(act), in_placements=(rep, tok),
                     in_grad_placements=(_data_partial(tok), tok), device_mesh=mesh)(table, tokens)


def _sharded_cross_entropy(x, head, targets, mask, mesh, rules: ShardingRules):
    """The fused CE on each rank's tokens, with the whole head: per rank the
    sum of its (masked) NLL and its token count, partial sums over the mesh
    dims that split the tokens, then their quotient."""
    act = rules.placements(mesh, ("batch", "seq", "act_embed"))
    tok = rules.placements(mesh, ("batch", "seq"))
    rep = [Replicate()] * mesh.ndim
    part = _data_partial(act)
    x, head = shard_tensor(x, mesh, act), shard_tensor(head, mesh, rep)
    targets = shard_tensor(targets, mesh, tok)
    if mask is not None:
        mask = shard_tensor(mask, mesh, tok)

    def local(x, head, targets, mask):
        count = (torch.tensor(float(targets.numel()), device=x.device) if mask is None
                 else mask.float().sum())
        # the fused CE's mean divides by max(count, 1): undo it exactly
        return fused_cross_entropy(x, head, targets, mask) * count.clamp(min=1.0), count

    tok_or_none = None if mask is None else tok
    total, count = local_map(
        local, out_placements=(part, part),
        in_placements=(act, rep, tok, tok_or_none),
        in_grad_placements=(act, part, tok, tok_or_none), device_mesh=mesh,
    )(x, head, targets, mask)
    return total.redistribute(mesh, rep) / count.redistribute(mesh, rep).clamp(min=1.0)


def cross_entropy_loss(logits, targets, mask=None):
    """logits: [B, S, V] fp32; targets: [B, S] integer. Mean (masked mean) NLL."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()
