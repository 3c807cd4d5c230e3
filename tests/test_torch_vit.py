"""Port parity, ViT: ray_tpu_torch.models.vit against ray_tpu.models.vit on
the CPU.

The same numpy images and labels, made from a seed, and the same weights
(JAX's, converted with ``params_from_jax``) go through the JAX function and
its PyTorch counterpart on ``ViTConfig.tiny()`` (fp32, attention
"reference"), as tests/test_model_llama.py::TestViT runs the JAX side, with
its matmuls at "highest" precision: patchify bit-equal, logits and loss at
atol/rtol 1e-5, every gradient at 1e-4; the parameters after 10 steps of
``adamw(3e-3)`` against ``optax.adamw(3e-3)`` by the rule of
tests/test_torch_rl.py's ``_close_after_adam``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import vit as jv
from ray_tpu_torch.models import vit as tv
from ray_tpu_torch.models.llama import params_from_jax
from ray_tpu_torch.train import step as ts
from test_torch_rl import _close_after_adam, _flat_jax

ATOL = RTOL = 1e-5
GRAD_TOL = 1e-4


def _data(seed, b=4, size=32, classes=10):
    rng = np.random.default_rng(seed)
    return (rng.random((b, size, size, 3)).astype(np.float32),
            rng.integers(0, classes, (b,)).astype(np.int32))


def _weights(seed=0):
    """(JAX params, the same converted to the port) for ViTConfig.tiny()."""
    jp = jv.vit_init(jv.ViTConfig.tiny(), jax.random.key(seed))
    return jp, params_from_jax(jp)


def test_config_presets_match_jax():
    for preset, kw in (("tiny", {}), ("vit_l", {}), ("vit_l", {"image_size": 256}),
                       (None, {})):
        j = getattr(jv.ViTConfig, preset)(**kw) if preset else jv.ViTConfig()
        t = getattr(tv.ViTConfig, preset)(**kw) if preset else tv.ViTConfig()
        for f in ("image_size", "patch_size", "num_channels", "hidden_size",
                  "intermediate_size", "num_layers", "num_heads", "num_classes",
                  "attention_impl", "rms_eps", "num_patches", "head_dim", "num_params"):
            assert getattr(t, f) == getattr(j, f), (preset, kw, f)
    assert tv.ViTConfig() == tv.ViTConfig(hidden_size=768, num_heads=12, num_layers=12)
    assert tv.ViTConfig().dtype == torch.bfloat16 and tv.ViTConfig.tiny().dtype == torch.float32
    assert tv.ViTConfig.vit_l().head_dim == tv.ViTConfig().head_dim == 64


@pytest.mark.parametrize("image_size,patch_size", [(32, 8), (64, 16), (48, 4)])
def test_patchify_is_bit_equal(image_size, patch_size):
    jc = jv.ViTConfig(image_size=image_size, patch_size=patch_size, dtype=jnp.float32)
    tc = tv.ViTConfig(image_size=image_size, patch_size=patch_size, dtype=torch.float32)
    images = np.random.default_rng(image_size).standard_normal(
        (3, image_size, image_size, 3)).astype(np.float32)
    want = np.asarray(jv.patchify(jc, jnp.asarray(images)))
    got = tv.patchify(tc, torch.from_numpy(images))
    assert tuple(got.shape) == want.shape == (3, tc.num_patches, patch_size ** 2 * 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vit_init_layout_and_seed():
    cfg = tv.ViTConfig.tiny()
    jp, _ = _weights()
    a, b = tv.vit_init(cfg, seed=3, device="cpu"), tv.vit_init(cfg, seed=3, device="cpu")
    assert set(a) == set(jp) and set(a["layers"]) == set(jp["layers"])
    for ta_, tb_, w in zip(ts._leaves(a), ts._leaves(b), _flat_jax(jp)):
        assert tuple(ta_.shape) == w.shape and ta_.dtype == torch.float32
        assert torch.equal(ta_, tb_)
    assert sum(t.numel() for t in ts._leaves(a)) == cfg.num_params
    assert not torch.equal(a["head"], tv.vit_init(cfg, seed=4, device="cpu")["head"])


def test_forward_and_loss_match_jax():
    cfg, jcfg = tv.ViTConfig.tiny(), jv.ViTConfig.tiny()
    jp, tp = _weights()
    images, labels = _data(0)
    with jax.default_matmul_precision("highest"):
        want_logits = np.asarray(jv.vit_forward(jp, jnp.asarray(images), jcfg))
        want_loss = float(jv.vit_loss(jp, jnp.asarray(images), jnp.asarray(labels), jcfg))
    logits = tv.vit_forward(tp, torch.from_numpy(images), cfg)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (4, 10)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=ATOL, rtol=RTOL)
    loss = tv.vit_loss(tp, torch.from_numpy(images), torch.from_numpy(labels), cfg)
    np.testing.assert_allclose(loss.item(), want_loss, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_attention_impls_agree_on_the_cpu(impl):
    """"auto" and "flash" reach the flash wrappers, which run their plain
    versions for CPU tensors: the same logits as "reference"."""
    _, tp = _weights()
    images = torch.from_numpy(_data(1)[0])
    want = tv.vit_forward(tp, images, tv.ViTConfig.tiny())
    cfg = dataclasses.replace(tv.ViTConfig.tiny(), attention_impl=impl)
    got = tv.vit_forward(tp, images, cfg)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def test_grads_match_jax():
    cfg, jcfg = tv.ViTConfig.tiny(), jv.ViTConfig.tiny()
    jp, tp = _weights(2)
    images, labels = _data(3)
    with jax.default_matmul_precision("highest"):
        jgrads = jax.grad(jv.vit_loss)(jp, jnp.asarray(images), jnp.asarray(labels), jcfg)
    leaves = ts._leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tv.vit_loss(tp, torch.from_numpy(images), torch.from_numpy(labels), cfg)
    grads = torch.autograd.grad(loss, leaves)
    want = _flat_jax(jgrads)
    assert len(grads) == len(want)
    for got, w in zip(grads, want):
        assert float(np.abs(w).max()) > 0
        np.testing.assert_allclose(got.numpy(), w, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("lr,b2,wd", [(3e-3, 0.999, 1e-4), (1e-2, 0.95, 0.1)])
def test_adamw_matches_optax(lr, b2, wd):
    """The counterpart of optax.adamw alone, on a small tree, several
    updates from the same state: a constant rate from the first update, no
    clipping (the gradients are far above any clip norm)."""
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    jopt = optax.adamw(lr, b2=b2, weight_decay=wd)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt = ts.adamw(lr, b2=b2, weight_decay=wd)
    tp = {"a": torch.from_numpy(params["a"].copy()),
          "b": {"c": torch.from_numpy(params["b"]["c"].copy())}}
    tstate = topt.init(tp)
    for _ in range(5):
        grads = jax.tree.map(lambda p: 10.0 * rng.standard_normal(p.shape).astype(np.float32),
                             params)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        g_norm = topt.update_([torch.from_numpy(g.copy()) for g in _flat_jax(grads)], tstate, tp)
        assert g_norm.item() > 1.0
        for got, want in zip(ts._leaves(tp), _flat_jax(jp)):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
    assert tstate.count == 5
    assert topt.schedule(0) == topt.schedule(4) == lr and topt.grad_clip is None


def test_train_steps_track_optax():
    """10 steps of make_vit_train_step with adamw(3e-3) against the JAX step
    with optax.adamw(3e-3), from the same converted weights and state."""
    cfg, jcfg = tv.ViTConfig.tiny(), jv.ViTConfig.tiny()
    jstep, jinit = jv.make_vit_train_step(jcfg, optax.adamw(3e-3))
    jp, jstate = jinit(jax.random.key(1))
    tstep, _ = tv.make_vit_train_step(cfg, ts.adamw(3e-3))
    tp = params_from_jax(jp)
    tstate = ts.adamw(3e-3).init(tp)
    images, labels = _data(1, b=8)
    ti, tl_ = torch.from_numpy(images), torch.from_numpy(labels)
    with jax.default_matmul_precision("highest"):
        for _ in range(10):
            jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(images), jnp.asarray(labels))
            out = tstep(tp, tstate, ti, tl_)
            assert out[0] is tp and out[1] is tstate
            # fp32 through a 10-step Adam trajectory, as
            # test_torch_train.py's test_train_steps_track_jax holds it
            assert abs(out[2].item() - float(jloss)) < 1e-4
    assert tstate.count == 10
    _close_after_adam(tp, jp)


def test_train_step_reduces_loss():
    """As TestViT.test_train_step_reduces_loss: 15 steps from a seeded init
    lower the loss."""
    step, init = tv.make_vit_train_step(tv.ViTConfig.tiny(), ts.adamw(3e-3))
    params, opt_state = init(seed=1, device="cpu")
    images, labels = map(torch.from_numpy, _data(1, b=8))
    losses = []
    for _ in range(15):
        params, opt_state, loss = step(params, opt_state, images, labels)
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_vit_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tv.ViTConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.vit_init(cfg)
    _, init = tv.make_vit_train_step(cfg, ts.adamw(1e-3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init()
