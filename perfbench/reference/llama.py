"""Plain reference of the Llama/Mistral decoder: forward, loss, gradients and
the AdamW update, in fp32 PyTorch, written from the published description
(Mistral-7B: RMSNorm before attention and MLP, rotary embeddings on the
half-rotation layout, grouped-query attention, SwiGLU, untied head).

It imports nothing of the program under test and takes nothing the program
made: the weights it reads are the benchmark's own (``perfbench/weights.py``),
in the same layout (``x @ W``, per-layer weights stacked on a leading axis).

Every product goes through ``mm``: ``exact`` is fp32 with TF32 off; ``fp8``
rounds both operands to float8 e4m3 (one scale a tensor, from its largest
magnitude) and multiplies in fp32, in the backward as in the forward. That
second precision is the control of ``perfbench/compare.py``: the step below
bf16 that a later change could take.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3 value


@dataclasses.dataclass(frozen=True)
class Dims:
    vocab: int
    hidden: int
    inter: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float
    eps: float


def no_tf32() -> None:
    """fp32 products in fp32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def exact(a, b):
    return torch.matmul(a.float(), b.float())


def fp8_round(t):
    """t rounded to float8 e4m3 with one scale for the tensor, back in fp32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def fp8(a, b):
    return _Fp8MatMul.apply(a.float(), b.float())


PRECISIONS: Dict[str, Callable] = {"exact": exact, "fp8": fp8}


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope_tables(d: Dims, positions, device):
    inv = 1.0 / d.rope_theta ** (torch.arange(0, d.head_dim, 2, dtype=torch.float64,
                                              device=device) / d.head_dim)
    ang = positions.to(torch.float64)[:, None] * inv[None, :]
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x, cos, sin):
    """x: [S, heads, D]; rotates the first half of D against the second."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, mm, q_block: int = 1024):
    """Causal attention of one sequence. q: [S, H, D]; k, v: [S, KV, D].
    Queries in blocks, so the [H, block, S] scores of one block are all that
    is held."""
    s, h, dh = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # [H, S, D]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    outs = []
    for i in range(0, s, q_block):
        qb = q[i:i + q_block].transpose(0, 1)  # [H, b, D]
        n = qb.shape[1]
        kv = i + n  # keys up to the block's last row
        scores = mm(qb, k[:, :kv].transpose(1, 2)) / math.sqrt(dh)
        rows = torch.arange(i, i + n, device=q.device)[:, None]
        cols = torch.arange(kv, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        outs.append(mm(torch.softmax(scores, dim=-1), v[:, :kv]).transpose(0, 1))
    return torch.cat(outs, dim=0)  # [S, H, D]


def layer(d: Dims, lw: Dict[str, torch.Tensor], x, cos, sin, mm):
    """One decoder layer on one sequence. x: [S, hidden] fp32."""
    s = x.shape[0]
    y = rms_norm(x, lw["attn_norm"], d.eps)
    q = rope(mm(y, lw["wq"]).reshape(s, d.heads, d.head_dim), cos, sin)
    k = rope(mm(y, lw["wk"]).reshape(s, d.kv_heads, d.head_dim), cos, sin)
    v = mm(y, lw["wv"]).reshape(s, d.kv_heads, d.head_dim)
    x = x + mm(attention(q, k, v, mm).reshape(s, d.heads * d.head_dim), lw["wo"])
    y = rms_norm(x, lw["mlp_norm"], d.eps)
    return x + mm(torch.nn.functional.silu(mm(y, lw["w_gate"])) * mm(y, lw["w_up"]),
                  lw["w_down"])


def layer_weights(params, i: int, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    return {n: w[i].to(dtype) for n, w in params["layers"].items()}


@torch.no_grad()
def logits(d: Dims, params, tokens, precision: str = "exact"):
    """fp32 logits [S, vocab] of one sequence (tokens: [S] on the weights'
    device), layer by layer: one layer's weights in fp32 at a time, so it
    fits beside bf16 weights of any size."""
    no_tf32()
    mm = PRECISIONS[precision]
    dev = params["embed_tokens"].device
    tokens = tokens.to(dev).long()
    cos, sin = rope_tables(d, torch.arange(tokens.numel(), device=dev), dev)
    x = params["embed_tokens"][tokens].float()
    for i in range(d.layers):
        x = layer(d, layer_weights(params, i), x, cos, sin, mm)
    x = rms_norm(x, params["final_norm"].float(), d.eps)
    return mm(x, params["lm_head"])


def loss(d: Dims, params32, tokens, targets, mm, checkpoint: bool = True):
    """Mean next-token cross-entropy over a batch. params32: fp32 leaves with
    gradients; tokens, targets: [B, S]. Each layer is recomputed in the
    backward when ``checkpoint``, so a long batch fits."""
    b, s = tokens.shape
    cos, sin = rope_tables(d, torch.arange(s, device=tokens.device), tokens.device)
    names = list(params32["layers"])
    total = 0.0
    for row in range(b):
        x = params32["embed_tokens"][tokens[row].long()]
        for i in range(d.layers):
            lw = {n: params32["layers"][n][i] for n in names}
            if checkpoint:
                x = torch.utils.checkpoint.checkpoint(
                    lambda x, *w: layer(d, dict(zip(names, w)), x, cos, sin, mm),
                    x, *(lw[n] for n in names), use_reentrant=False)
            else:
                x = layer(d, lw, x, cos, sin, mm)
        x = rms_norm(x, params32["final_norm"], d.eps)
        lg = mm(x, params32["lm_head"])
        total = total + torch.nn.functional.cross_entropy(
            lg, targets[row].long(), reduction="sum")
    return total / (b * s)


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flat {dotted name: tensor} of a nested dict (stacked layers stay whole)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW after a clip to global norm, on a linear warm-up from 0 and a
    cosine decay to a tenth (the schedule is read before each update, so the
    first update runs at rate 0)."""
    lr: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000

    def rate(self, count: int) -> float:
        if count < self.warmup_steps:
            return self.lr * count / self.warmup_steps
        decay = max(self.total_steps, self.warmup_steps + 1) - self.warmup_steps
        t = min(count - self.warmup_steps, decay)
        return self.lr * (0.9 * 0.5 * (1 + math.cos(math.pi * t / decay)) + 0.1)


def train_steps(d: Dims, params, batches: List, opt: AdamW, precision: str = "exact",
                drop_half: bool = False) -> dict:
    """``len(batches)`` AdamW steps from ``params`` (bf16 or fp32; not
    changed) in fp32. Returns each step's loss, the first step's clipped
    gradient norm per leaf (the gradient as the update takes it), and the
    norm of each leaf's change after the last step. ``drop_half`` computes
    each loss on the first half of the batch only: a fault the comparison
    must catch."""
    no_tf32()
    mm = PRECISIONS[precision]
    p32 = {k: ({n: w.detach().float().clone().requires_grad_(True) for n, w in v.items()}
               if isinstance(v, dict) else v.detach().float().clone().requires_grad_(True))
           for k, v in params.items()}
    flat = leaves(p32)
    m = {k: torch.zeros_like(v) for k, v in flat.items()}
    v2 = {k: torch.zeros_like(v) for k, v in flat.items()}
    losses, first_grad = [], {}
    for step, (tokens, targets) in enumerate(batches):
        if drop_half:
            half = tokens.shape[0] // 2
            tokens, targets = tokens[:half], targets[:half]
        lv = loss(d, p32, tokens, targets, mm)
        grads = torch.autograd.grad(lv, list(flat.values()))
        losses.append(float(lv.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
            scale = torch.clamp(opt.grad_clip / norm, max=1.0)
            lr = opt.rate(step)
            c = step + 1
            for (name, p), g in zip(flat.items(), grads):
                g = g * scale
                if step == 0:
                    first_grad[name] = _leaf_norms(name, g)
                m[name].mul_(opt.b1).add_(g, alpha=1 - opt.b1)
                v2[name].mul_(opt.b2).addcmul_(g, g, value=1 - opt.b2)
                mhat = m[name] / (1 - opt.b1 ** c)
                vhat = v2[name] / (1 - opt.b2 ** c)
                p.sub_(lr * (mhat / (vhat.sqrt() + opt.eps) + opt.weight_decay * p))
    with torch.no_grad():
        start = leaves(params)
        change = {name: _leaf_norms(name, p - start[name].float()) for name, p in flat.items()}
    return {"losses": losses, "first_grad": _merge(first_grad), "change": _merge(change)}


def _leaf_norms(name: str, t) -> Dict[str, float]:
    """Per-layer norms of a stacked leaf ({name.i: norm}), or {name: norm}."""
    if name.startswith("layers."):
        return {f"{name}.{i}": float(t[i].double().norm()) for i in range(t.shape[0])}
    return {name: float(t.double().norm())}


def _merge(parts: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    out = {}
    for d in parts.values():
        out.update(d)
    return out
