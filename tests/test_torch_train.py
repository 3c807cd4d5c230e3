"""Port parity, training: ray_tpu_torch's loss, rematerialization, optimizer and
train step against ray_tpu's on the CPU.

The same numpy inputs and the same converted weights (and optimizer state)
go through the JAX function and its PyTorch counterpart, in fp32, on
``LlamaConfig.tiny``, at the JAX tests' tolerances. The port's flash op
takes its plain versions for CPU tensors."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.train import step as js
from ray_tpu_torch.models import llama as tl
import ray_tpu_torch.ops.attention as ta
from ray_tpu_torch.train import step as ts

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32, remat=None, attention_impl="reference")


def _tcfg(**kw):
    kw.setdefault("remat", None)
    return tl.LlamaConfig.tiny(dtype=torch.float32, **kw)


def _tokens(seed, shape=(2, 32)):
    tokens = np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _grads(params, tokens, targets, cfg, mask=None):
    leaves = ts._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = tl.llama_loss(params, torch.from_numpy(tokens).long(),
                         torch.from_numpy(targets).long(), cfg, mask=mask)
    return loss, torch.autograd.grad(loss, leaves)


def _flat_jax(tree):
    """JAX pytree leaves in the port's _leaves order (key-sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat_jax(tree[k])]
    return [np.asarray(tree)]


@pytest.mark.parametrize("tie,with_mask", [(False, False), (True, False), (False, True)])
def test_llama_loss_and_grads_match_jax(tie, with_mask):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, remat=None, attention_impl="reference",
                               tie_embeddings=tie)
    jp = jl.llama_init(jcfg, jax.random.key(1))
    tokens, targets = _tokens(4, (2, 64))
    mask = np.random.default_rng(5).integers(0, 2, tokens.shape).astype(np.float32)
    jm = jnp.asarray(mask) if with_mask else None
    with jax.default_matmul_precision("highest"):
        jloss, jgrads = jax.value_and_grad(
            lambda p: jl.llama_loss(p, jnp.asarray(tokens), jnp.asarray(targets), jcfg,
                                    mask=jm))(jp)
    loss, grads = _grads(tl.params_from_jax(jp), tokens, targets, _tcfg(tie_embeddings=tie),
                         mask=torch.from_numpy(mask) if with_mask else None)
    assert abs(loss.item() - float(jloss)) < 1e-5
    for got, want in zip(grads, _flat_jax(jgrads)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_llama_loss_matches_forward_plus_cross_entropy():
    cfg = _tcfg()
    params = tl.params_from_jax(jl.llama_init(JCFG, jax.random.key(1)))
    tokens, targets = map(lambda a: torch.from_numpy(a).long(), _tokens(4, (2, 64)))
    with torch.no_grad():
        l1 = tl.llama_loss(params, tokens, targets, cfg)
        l2 = tl.cross_entropy_loss(tl.llama_forward(params, tokens, cfg), targets)
    assert abs(l1.item() - l2.item()) < 1e-5


@pytest.mark.parametrize("remat", ["full", "nothing_saveable", "mlp_only", "save_attn"])
def test_remat_modes_same_loss_and_grads(remat):
    """Every remat mode is a memory/compute trade only: the loss and every
    gradient equal those of remat=None."""
    params = tl.params_from_jax(jl.llama_init(JCFG, jax.random.key(0)))
    tokens, targets = _tokens(3)
    l0, g0 = _grads(params, tokens, targets, _tcfg())
    l1, g1 = _grads(params, tokens, targets, _tcfg(remat=remat))
    assert abs(l0.item() - l1.item()) < 1e-5
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("remat,per_layer", [
    (None, 1), ("mlp_only", 1), ("save_attn", 1), ("full", 2), ("nothing_saveable", 2)])
def test_attention_forward_runs_per_layer(remat, per_layer):
    """save_attn keeps the flash op's outputs: one forward and backward run
    the attention forward L times, where whole-layer remat runs it 2L times."""
    cfg = _tcfg(remat=remat)
    params = tl.params_from_jax(jl.llama_init(JCFG, jax.random.key(0)))
    tokens, targets = _tokens(3)
    calls = []
    real = ta.reference_attention_lse

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    with mock.patch.object(ta, "reference_attention_lse", counting):
        _grads(params, tokens, targets, cfg)
    assert len(calls) == per_layer * cfg.num_layers


def test_unknown_remat_is_refused():
    params = tl.params_from_jax(jl.llama_init(JCFG, jax.random.key(0)))
    tokens, targets = _tokens(3)
    with pytest.raises(ValueError, match="unknown remat"):
        _grads(params, tokens, targets, _tcfg(remat="dots"))


@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 10, 1000), (1e-2, 1, 50), (1e-3, 100, 50)])
def test_schedule_matches_optax(lr, warmup, total):
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1), end_value=lr * 0.1)
    opt = ts.default_optimizer(lr=lr, warmup_steps=warmup, total_steps=total)
    for count in (0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total, 5 * total):
        np.testing.assert_allclose(opt.schedule(count), float(want(count)), rtol=1e-6,
                                   atol=1e-12)
    assert opt.schedule(0) == 0.0


@pytest.mark.parametrize("grad_scale", [1e-2, 10.0])  # below and above the clip norm
def test_optimizer_matches_optax(grad_scale):
    """Clip, AdamW and the schedule on a small tree, several updates, from the
    same state; the first update runs at lr 0."""
    rng = np.random.default_rng(6)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    jopt = js.default_optimizer(lr=1e-2, warmup_steps=2, total_steps=10)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt = ts.default_optimizer(lr=1e-2, warmup_steps=2, total_steps=10)
    tp = {"a": torch.from_numpy(params["a"].copy()), "b": {"c": torch.from_numpy(params["b"]["c"].copy())}}
    tstate = topt.init(tp)
    for i in range(5):
        grads = jax.tree.map(lambda p: grad_scale * rng.standard_normal(p.shape).astype(np.float32),
                             params)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update_([torch.from_numpy(g.copy()) for g in _flat_jax(grads)], tstate, tp)
        for got, want in zip(ts._leaves(tp), _flat_jax(jp)):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)
        if i == 0:
            np.testing.assert_array_equal(tp["a"].numpy(), params["a"])
    assert tstate.count == 5


def _jax_train_state(opt_kw, steps=0, tokens=None, targets=None):
    jopt = js.default_optimizer(**opt_kw)
    jstate = js.make_train_state_factory(JCFG, jopt)(jax.random.key(0))
    jstep = js.make_train_step(JCFG, jopt, donate=False)
    for _ in range(steps):
        jstate, _ = jstep(jstate, tokens, targets)
    return jopt, jstate, jstep


def test_train_state_from_jax_carries_count_and_moments():
    tokens, targets = map(jnp.asarray, _tokens(1, (2, 32)))
    _, jstate, _ = _jax_train_state(dict(lr=1e-2, warmup_steps=1, total_steps=50), 2,
                                            tokens, targets)
    state = ts.train_state_from_jax(jstate)
    assert state.step == 2 and state.opt_state.count == 2
    adam = jstate.opt_state[1][0]
    for got, want in zip(ts._leaves(state.opt_state.mu), _flat_jax(adam.mu)):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(ts._leaves(state.opt_state.nu), _flat_jax(adam.nu)):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, want in zip(ts._leaves(state.params), _flat_jax(jstate.params)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_train_steps_track_jax():
    """10 steps of both frameworks from the same converted state: the losses
    and the parameters track each other, and the loss falls (as in
    tests/test_model_llama.py)."""
    tokens, targets = _tokens(1, (4, 64))
    opt_kw = dict(lr=1e-2, warmup_steps=1, total_steps=50)
    jopt, jstate, jstep = _jax_train_state(opt_kw)
    state = ts.train_state_from_jax(jstate)
    tstep = ts.make_train_step(_tcfg(), ts.default_optimizer(**opt_kw))
    tt, tg = torch.from_numpy(tokens), torch.from_numpy(targets)
    losses = []
    with jax.default_matmul_precision("highest"):
        for _ in range(10):
            jstate, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
            state, m = tstep(state, tt, tg)
            losses.append(m["loss"].item())
            # fp32 through 2 layers and a 10-step Adam trajectory: rounding
            # differences grow with each update, hence 1e-4 and not 1e-5
            assert abs(m["loss"].item() - float(jm["loss"])) < 1e-4
            np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    assert state.step == 10 and m["step"] == 10 and state.opt_state.count == 10
    assert losses[-1] < losses[0] * 0.9, losses
    # Parameters: Adam's first real update is g / (|g| + 1e-8) per element, so
    # where a gradient element lies within fp32 rounding noise of 0 that noise
    # moves the update by up to lr. Such elements (3 of ~310k here) are held
    # to within one update (lr) of JAX's; every other element to 1e-4.
    diffs = [np.abs(got.detach().numpy() - want) - 1e-4 * np.abs(want)
             for got, want in zip(ts._leaves(state.params), _flat_jax(jstate.params))]
    n_far = sum(int((d > 1e-4).sum()) for d in diffs)
    n_all = sum(d.size for d in diffs)
    assert n_far <= 1e-4 * n_all, (n_far, n_all)
    assert max(float(d.max()) for d in diffs) <= opt_kw["lr"]


def test_train_state_factory_and_eval_step():
    cfg = _tcfg()
    init = ts.make_train_state_factory(cfg, ts.default_optimizer())
    state = init(seed=0, device="cpu")
    assert state.step == 0 and state.opt_state.count == 0
    assert all(torch.count_nonzero(m) == 0 for m in ts._leaves(state.opt_state.mu))
    jp = jl.llama_init(JCFG, jax.random.key(2))
    tokens, targets = _tokens(7)
    with jax.default_matmul_precision("highest"):
        want = float(js.make_eval_step(JCFG)(jp, jnp.asarray(tokens), jnp.asarray(targets)))
    got = ts.make_eval_step(cfg)(tl.params_from_jax(jp), torch.from_numpy(tokens),
                                 torch.from_numpy(targets))
    assert abs(got.item() - want) < 1e-5


def test_train_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    init = ts.make_train_state_factory(_tcfg(), ts.default_optimizer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init(seed=0)


def test_bench_reports_skipped_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ray_tpu_torch.bench import train_bench

    res = train_bench()
    assert res["skipped"] is True and "value" not in res and "mfu" not in res
