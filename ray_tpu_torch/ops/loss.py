"""Fused LM-head + cross-entropy, sequence-chunked (port of ray_tpu/ops/loss.py).

``x @ head`` over a [B, S, V] vocabulary followed by softmax-CE would hold
[B, S, V] fp32 logits and their gradient only to reduce them. This op
streams the head product and the CE over sequence chunks:

- forward: per chunk, fp32 logits, then the log-sum-exp and the gold logit;
  only per-token lse ([B, S] fp32) survives the chunk;
- backward: per chunk, the logits are recomputed and
  ``dlogit = (softmax - onehot) * g / denom * mask`` (cast to ``x.dtype``) is
  contracted at once into ``dx_c`` (``x.dtype``) and an fp32 ``dhead``
  accumulator, cast to ``head.dtype`` at the end.

The products stay ``torch.matmul``/``torch.mm`` (cuBLAS on the card), as the
JAX package leaves them to XLA: no Pallas kernel is involved. The gold logit
is a gather rather than JAX's one-hot select-reduce (which exists for
sharded vocabularies); both give the same numbers.
"""

from __future__ import annotations

import torch

DEFAULT_CE_CHUNKS = 8


def _resolve_chunks(s: int, n_chunks: int) -> int:
    """Largest divisor of s that is <= n_chunks (ragged sequence lengths still
    chunk as finely as possible)."""
    for c in range(min(n_chunks, s), 0, -1):
        if s % c == 0:
            return c
    return 1


def _mm_f32(a, b):
    """a [M, K] . b [K, N] with fp32 accumulation and an fp32 result (JAX's
    ``preferred_element_type=float32``); bf16 operands stay on the tensor
    cores on the card."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunks(s: int, n_chunks: int):
    c = _resolve_chunks(s, n_chunks)
    size = s // c
    return [slice(i * size, (i + 1) * size) for i in range(c)]


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, head, targets, mask, n_chunks):
        b, s, h = x.shape
        lse = torch.empty((b, s), dtype=torch.float32, device=x.device)
        nll = torch.empty_like(lse)
        for sl in _chunks(s, n_chunks):
            logits = _mm_f32(x[:, sl].reshape(-1, h), head)
            lse_c = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(1, targets[:, sl].reshape(-1, 1).long())[:, 0]
            lse[:, sl] = lse_c.view(b, -1)
            nll[:, sl] = (lse_c - gold).view(b, -1)
        if mask is not None:
            mask = mask.float()
            denom = mask.sum().clamp(min=1.0)
            loss = (nll * mask).sum() / denom
        else:
            denom = torch.tensor(float(nll.numel()), device=x.device)
            loss = nll.mean()
        ctx.save_for_backward(x, head, targets, mask, lse, denom)
        ctx.n_chunks = n_chunks
        return loss

    @staticmethod
    def backward(ctx, g):
        x, head, targets, mask, lse, denom = ctx.saved_tensors
        b, s, h = x.shape
        scale = g / denom  # d(loss) / d(nll of one token), uniform
        dx = torch.empty_like(x)
        dhead = torch.zeros(head.shape, dtype=torch.float32, device=head.device)
        for sl in _chunks(s, ctx.n_chunks):
            x_c = x[:, sl].reshape(-1, h)
            p = torch.exp(_mm_f32(x_c, head) - lse[:, sl].reshape(-1, 1))
            p.scatter_add_(1, targets[:, sl].reshape(-1, 1).long(),
                           torch.full((p.shape[0], 1), -1.0, device=p.device))
            dlogit = p * scale
            if mask is not None:
                dlogit = dlogit * mask[:, sl].reshape(-1, 1)
            dlogit = dlogit.to(x.dtype)
            dx[:, sl] = (dlogit @ head.T).view(b, -1, h)
            dhead += _mm_f32(x_c.T, dlogit)
        return dx, dhead.to(head.dtype), None, None, None


def fused_cross_entropy(x, head, targets, mask=None, n_chunks: int = DEFAULT_CE_CHUNKS):
    """x: [B, S, H]; head: [H, V]; targets: [B, S] integer; mask: [B, S] or
    None. Returns the mean (masked mean) NLL, an fp32 scalar."""
    return _FusedCE.apply(x, head, targets, mask, n_chunks)

