"""ViT: vision transformer in PyTorch (port of ray_tpu/models/vit.py).

Keeps the JAX package's parameter layout, so weights convert one to one with
the tree-generic ``models/llama.py:params_from_jax``:

- patchify is a reshape and a transpose, then one matmul with
  ``patch_embed`` [P*P*C, H]: no convolution;
- the encoder layers are stacked along a leading [L] axis under
  ``params["layers"]`` and run in a loop over L (the JAX module's
  ``lax.scan``), with no rematerialization, as there;
- x @ W orientation; pre-RMSNorm blocks (``rms_eps``), non-causal attention
  with as many kv heads as q heads, an MLP through the tanh approximation of
  GELU (``jax.nn.gelu``'s default);
- a mean-pool head, no CLS token; fp32 logits, and the loss a mean of fp32
  log-softmax terms.

``attention_impl``: ``"auto"`` and ``"flash"`` go through
``ops.attention.attention(causal=False)``, so on the card a head dim of 64
or 128 (ViT-B/16, ViT-L/16: 64) runs the flash kernels: K1 with no gradient,
K1', K2 and K3 in a train step. ``"reference"`` is the plain path. The JAX
module's ``"auto"`` takes its reference path off the TPU; the port's runs the
kernels on the card and their plain versions on the CPU, the same function.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "auto"   # auto|flash|reference
    rms_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_params(self) -> int:
        h, f, L = self.hidden_size, self.intermediate_size, self.num_layers
        patch = self.patch_size ** 2 * self.num_channels * h
        per_layer = 4 * h * h + 2 * h * f + 2 * h
        return (patch + self.num_patches * h + L * per_layer + h
                + h * self.num_classes)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, hidden_size=64,
                   intermediate_size=128, num_layers=2, num_heads=4,
                   num_classes=10, dtype=torch.float32,
                   attention_impl="reference", **kw)

    @classmethod
    def vit_l(cls, **kw) -> "ViTConfig":
        """ViT-L/16."""
        return cls(hidden_size=1024, intermediate_size=4096, num_layers=24,
                   num_heads=16, **kw)


def vit_init(config: ViTConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (on the
    card unless ``device="cpu"``): scaled normal (fan-in**-0.5) and position
    embeddings at 0.02, as the JAX package draws them. The numbers differ
    from JAX's, so parity tests convert JAX's with ``params_from_jax``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    h, f, L = config.hidden_size, config.intermediate_size, config.num_layers
    patch_dim = config.patch_size ** 2 * config.num_channels
    dt = config.dtype

    def randn(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)

    def normal(shape, fan_in):
        return (randn(shape) * fan_in ** -0.5).to(dt)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=dev)

    return {
        "patch_embed": normal((patch_dim, h), patch_dim),
        "pos_embed": (randn((config.num_patches, h)) * 0.02).to(dt),
        "layers": {
            "attn_norm": ones((L, h)),
            "wq": normal((L, h, h), h),
            "wk": normal((L, h, h), h),
            "wv": normal((L, h, h), h),
            "wo": normal((L, h, h), h),
            "mlp_norm": ones((L, h)),
            "w_up": normal((L, h, f), h),
            "w_down": normal((L, f, h), f),
        },
        "final_norm": ones((h,)),
        "head": normal((h, config.num_classes), h),
    }


def _layer(config: ViTConfig, x, lp: Dict[str, torch.Tensor]):
    """One encoder layer. x: [B, N, H]; lp: per-layer params (no leading L)."""
    b, n, h = x.shape
    nh, d = config.num_heads, config.head_dim
    y = rms_norm(x, lp["attn_norm"], config.rms_eps)
    q = (y @ lp["wq"]).reshape(b, n, nh, d)
    k = (y @ lp["wk"]).reshape(b, n, nh, d)
    v = (y @ lp["wv"]).reshape(b, n, nh, d)
    a = attention(q, k, v, causal=False, impl=config.attention_impl).reshape(b, n, h)
    x = x + a @ lp["wo"]
    y = rms_norm(x, lp["mlp_norm"], config.rms_eps)
    return x + F.gelu(y @ lp["w_up"], approximate="tanh") @ lp["w_down"]


def patchify(config: ViTConfig, images) -> torch.Tensor:
    """[B, Hi, Wi, C] -> [B, N, P*P*C] by reshape and transpose alone: patch
    (i, j) is the image's block at rows P i.., columns P j.., row-major."""
    b = images.shape[0]
    p = config.patch_size
    g = config.image_size // p
    x = images.reshape(b, g, p, g, p, config.num_channels)
    x = x.permute(0, 1, 3, 2, 4, 5)  # B, g, g, p, p, C
    return x.reshape(b, g * g, p * p * config.num_channels)


def vit_forward(params: Dict[str, Any], images, config: ViTConfig) -> torch.Tensor:
    """images: [B, Hi, Wi, C] float -> logits [B, num_classes] (fp32)."""
    x = patchify(config, images.to(config.dtype)) @ params["patch_embed"]
    x = x + params["pos_embed"][None]
    # one unbind per stacked weight: its backward stacks the L layer
    # gradients once (as llama_hidden does)
    names = list(params["layers"])
    for weights in zip(*(params["layers"][n].unbind(0) for n in names)):
        x = _layer(config, x, dict(zip(names, weights)))
    x = rms_norm(x, params["final_norm"], config.rms_eps)
    return (x.mean(dim=1) @ params["head"]).float()


def vit_loss(params: Dict[str, Any], images, labels, config: ViTConfig) -> torch.Tensor:
    """Mean softmax cross-entropy over [B] integer labels."""
    logp = torch.log_softmax(vit_forward(params, images, config), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()


def make_vit_train_step(config: ViTConfig, optimizer):
    """One forward, backward and optimizer update; returns (step_fn, init_fn).

    ``init_fn(seed=0, device=None) -> (params, opt_state)``;
    ``step_fn(params, opt_state, images, labels) -> (params, opt_state, loss)``
    updates params and opt_state in place and returns the same objects.
    ``optimizer`` is one of ``train.step``'s (``adamw(lr)`` is the
    counterpart of the ``optax.adamw(lr)`` the JAX ViT is trained with)."""
    # train.step imports models (llama), so this import cannot sit at the top
    from ray_tpu_torch.train.step import _leaves

    def init(seed: int = 0, device=None):
        params = vit_init(config, seed, device)
        return params, optimizer.init(params)

    def step(params, opt_state, images, labels):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = vit_loss(params, images, labels, config)
            grads = list(torch.autograd.grad(loss, leaves))
        optimizer.update_(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return step, init
