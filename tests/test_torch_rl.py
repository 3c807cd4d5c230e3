"""Port parity, RL: ray_tpu_torch.rl (GRPO, PPO, GRPOTrainer) against
ray_tpu.rl on the CPU.

The same numpy inputs and the same converted weights go through the JAX
function and its PyTorch counterpart, in fp32, on ``LlamaConfig.tiny``:
advantages at 1e-6, GAE at 1e-5 and logprobs at 1e-4 (tests/test_rl.py's
tolerances); losses, their metrics and every gradient, and the parameters
after optimizer steps, at tests/test_torch_train.py's atol 1e-5, rtol 1e-4.
The JAX side runs its matmuls at "highest" precision."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.rl import grpo as jgrpo
from ray_tpu.rl import ppo as jppo
from ray_tpu.rl.trainer import GRPOTrainer as JTrainer
from ray_tpu.train import step as js
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.rl import grpo as tgrpo
from ray_tpu_torch.rl import ppo as tppo
from ray_tpu_torch.rl.trainer import GRPOTrainer, _clone
from ray_tpu_torch.serve.llm import LLMEngine
from ray_tpu_torch.train import step as ts

ATOL, RTOL = 1e-5, 1e-4


def _jcfg(**kw):
    return jl.LlamaConfig.tiny(dtype=jnp.float32, remat=None, attention_impl="reference", **kw)


def _tcfg(**kw):
    kw.setdefault("remat", None)
    return tl.LlamaConfig.tiny(dtype=torch.float32, **kw)


def _flat_jax(tree):
    """JAX pytree leaves in the port's _leaves order (key-sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat_jax(tree[k])]
    return [np.asarray(tree)]


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), atol=atol, rtol=rtol)


def _close_trees(got_tree, want_tree):
    got, want = ts._leaves(got_tree), _flat_jax(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


# Parameters after Adam steps: how many elements (of ~361k) may miss
# atol/rtol, and by how much at most. Measured on the CPU: 1, 4 and 5
# elements beyond the tolerance, by at most 1.5e-5, 4.0e-5 and 5.7e-5 (the
# GRPO step, PPO step and trainer tests).
ADAM_FAR_COUNT, ADAM_FAR_ATOL = 8, 2e-4


def _close_after_adam(got_tree, want_tree):
    """Parameters after Adam steps. Adam's update is about lr * g / |g| per
    element, so where a gradient element lies within fp32 rounding of 0
    (|g| ~1e-7 against a largest |g| ~0.1) that rounding moves the update by
    a share of lr. At most ADAM_FAR_COUNT such elements may miss atol 1e-5,
    rtol 1e-4 (the rule of test_torch_train.py's test_train_steps_track_jax),
    and by no more than ADAM_FAR_ATOL; every other element keeps it."""
    got, want = ts._leaves(got_tree), _flat_jax(want_tree)
    assert len(got) == len(want)
    diffs = [np.abs(g.detach().numpy() - w) - RTOL * np.abs(w) for g, w in zip(got, want)]
    n_far = sum(int((d > ATOL).sum()) for d in diffs)
    assert n_far <= ADAM_FAR_COUNT, n_far
    assert max(float(d.max()) for d in diffs) <= ADAM_FAR_ATOL


def _requires_grad(tree):
    leaves = ts._leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    return leaves


# --------------------------------------------------------------------------- #
# GRPO and PPO math
# --------------------------------------------------------------------------- #
def test_group_advantages_match_jax():
    rng = np.random.default_rng(0)
    rewards = np.concatenate([
        np.asarray([[1.0, 2.0, 3.0, 6.0], [0.0, 0.0, 0.0, 0.0],   # a degenerate group: std 0
                    [0.25, 0.25, 0.25, 0.25]], np.float32),
        rng.standard_normal((3, 4)).astype(np.float32)])
    want = jgrpo.compute_group_advantages(jnp.asarray(rewards))
    got = tgrpo.compute_group_advantages(torch.from_numpy(rewards))
    _close(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.zeros(4))


@pytest.mark.parametrize("gamma,lam", [(0.95, 0.9), (1.0, 0.95)])
def test_gae_matches_jax(gamma, lam):
    rng = np.random.default_rng(1)
    B, T = 3, 7
    rewards = rng.standard_normal((B, T)).astype(np.float32)
    values = rng.standard_normal((B, T)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 4:] = 0.0  # a masked row: padding after position 3
    mask[2, 6:] = 0.0
    want = jppo.gae_advantages(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(mask),
                               gamma, lam)
    got = tppo.gae_advantages(torch.from_numpy(rewards), torch.from_numpy(values),
                              torch.from_numpy(mask), gamma, lam)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-5, rtol=0)
    # the last valid step of the masked row bootstraps from 0: r - V exactly
    _close(got[0][1, 3], rewards[1, 3] - values[1, 3], atol=1e-5, rtol=0)


@pytest.mark.parametrize("tie", [False, True])
def test_logprob_fn_matches_jax(tie):
    jcfg = _jcfg(tie_embeddings=tie)
    jp = jl.llama_init(jcfg, jax.random.key(0))
    tokens = np.random.default_rng(2).integers(0, 256, (3, 21)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = jgrpo.make_logprob_fn(jcfg)(jp, jnp.asarray(tokens))
    got = tgrpo.make_logprob_fn(_tcfg(tie_embeddings=tie))(tl.params_from_jax(jp),
                                                            torch.from_numpy(tokens))
    assert got.shape == (3, 20) and not got.requires_grad
    _close(got, want, atol=1e-4, rtol=0)


def _grpo_inputs(jp, jcfg, seed, n=6, t=19):
    """tokens, a completion mask from ragged prompt and sequence lengths,
    advantages of both signs, and old/ref logprobs off the policy's own (so
    that some ratios clip and the KL is not 0)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (n, t)).astype(np.int32)
    mask = np.zeros((n, t - 1), np.float32)
    for i in range(n):
        p, s = int(rng.integers(2, 8)), int(rng.integers(10, t + 1))
        mask[i, p - 1:s - 1] = 1.0
    with jax.default_matmul_precision("highest"):
        lp = np.asarray(jgrpo.make_logprob_fn(jcfg)(jp, jnp.asarray(tokens)))
    old = (lp + 0.3 * rng.standard_normal(lp.shape)).astype(np.float32)
    ref = (lp + 0.5 * rng.standard_normal(lp.shape)).astype(np.float32)
    adv = rng.standard_normal((n,)).astype(np.float32)
    return {"tokens": tokens, "completion_mask": mask, "advantages": adv,
            "old_logprobs": old, "ref_logprobs": ref}


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grpo_args(b):
    return (b["tokens"], b["completion_mask"], b["advantages"], b["old_logprobs"],
            b["ref_logprobs"])


@pytest.mark.parametrize("tie", [False, True])
def test_grpo_loss_and_grads_match_jax(tie):
    jcfg = _jcfg(tie_embeddings=tie)
    jp = jl.llama_init(jcfg, jax.random.key(3))
    batch = _grpo_inputs(jp, jcfg, 4)
    clip, kl_coef = 0.2, 0.05
    with jax.default_matmul_precision("highest"):
        (jloss, jaux), jgrads = jax.value_and_grad(
            lambda p: jgrpo.grpo_loss(p, *_grpo_args(_to_jax(batch)), jcfg, clip, kl_coef),
            has_aux=True)(jp)
    params = tl.params_from_jax(jp)
    leaves = _requires_grad(params)
    loss, aux = tgrpo.grpo_loss(params, *_grpo_args(_to_torch(batch)),
                                _tcfg(tie_embeddings=tie), clip, kl_coef)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jloss)
    assert set(aux) == set(jaux) == {"pg_loss", "kl", "ratio_mean"}
    for k in aux:
        _close(aux[k], jaux[k])
    assert float(aux["kl"].detach()) > 0.01  # the KL term is exercised
    for g, w in zip(grads, _flat_jax(jgrads)):
        _close(g, w)


def _ppo_batch(jp, jvh, jcfg, seed, b=4, t=15):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (b, t)).astype(np.int32)
    mask = np.ones((b, t - 1), np.float32)
    mask[1, 9:] = 0.0
    mask[3, 5:] = 0.0
    with jax.default_matmul_precision("highest"):
        lp = np.asarray(jgrpo.make_logprob_fn(jcfg)(jp, jnp.asarray(tokens)))
        values = np.asarray(jppo.value_estimates(jp, jvh, jnp.asarray(tokens), jcfg))[:, :-1]
    rewards = rng.standard_normal((b, t - 1)).astype(np.float32)
    adv, ret = jppo.gae_advantages(jnp.asarray(rewards), jnp.asarray(values),
                                   jnp.asarray(mask), 1.0, 0.95)
    return {"tokens": tokens, "mask": mask,
            "old_logprobs": (lp + 0.2 * rng.standard_normal(lp.shape)).astype(np.float32),
            "advantages": np.asarray(adv), "returns": np.asarray(ret),
            "old_values": (values + 0.3 * rng.standard_normal(values.shape)).astype(np.float32)}


@pytest.mark.parametrize("ppo_kw", [{}, {"entropy_coef": 0.01, "value_clip": 0.05}])
def test_ppo_loss_and_grads_match_jax(ppo_kw):
    jcfg = _jcfg()
    jp = jl.llama_init(jcfg, jax.random.key(5))
    jvh = jppo.init_value_head(jcfg, jax.random.key(6))
    batch = _ppo_batch(jp, jvh, jcfg, 7)
    jcfg_ppo, tcfg_ppo = jppo.PPOConfig(**ppo_kw), tppo.PPOConfig(**ppo_kw)
    with jax.default_matmul_precision("highest"):
        (jloss, jaux), (jg, jvg) = jax.value_and_grad(
            lambda p, vh: jppo.ppo_loss(p, vh, _to_jax(batch), jcfg, jcfg_ppo),
            argnums=(0, 1), has_aux=True)(jp, jvh)
    params, vh = tl.params_from_jax(jp), tppo.value_head_from_jax(jvh)
    leaves = _requires_grad(params) + _requires_grad(vh)
    loss, aux = tppo.ppo_loss(params, vh, _to_torch(batch), _tcfg(), tcfg_ppo)
    grads = torch.autograd.grad(loss, leaves)
    _close(loss, jloss)
    assert set(aux) == set(jaux) == {"pg_loss", "value_loss", "entropy"}
    for k in aux:
        _close(aux[k], jaux[k])
    for g, w in zip(grads, _flat_jax(jg) + _flat_jax(jvg)):
        _close(g, w)


def test_value_estimates_and_value_head_match_jax():
    jcfg = _jcfg()
    jp = jl.llama_init(jcfg, jax.random.key(8))
    jvh = jppo.init_value_head(jcfg, jax.random.key(9))
    tokens = np.random.default_rng(10).integers(0, 256, (2, 11)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = jppo.value_estimates(jp, jvh, jnp.asarray(tokens), jcfg)
    vh = tppo.value_head_from_jax(jvh)
    assert vh["w"].dtype == torch.float32 and vh["b"].shape == ()
    with torch.no_grad():
        got = tppo.value_estimates(tl.params_from_jax(jp), vh, torch.from_numpy(tokens), _tcfg())
    _close(got, want)
    own = tppo.init_value_head(_tcfg(), torch.Generator().manual_seed(0), device="cpu")
    assert own["w"].shape == (128,) and float(own["b"]) == 0.0
    assert abs(float(own["w"].std()) - 128 ** -0.5) < 0.3 * 128 ** -0.5
    with pytest.raises(ValueError, match="keys w and b"):
        tppo.value_head_from_jax({"w": np.zeros(3, np.float32)})


# --------------------------------------------------------------------------- #
# Steps: optax.adam on the JAX side, the port's AdamW set to the same update
# --------------------------------------------------------------------------- #
def _port_adam():
    """optax.adam(3e-3): no weight decay, b2 0.999, no clipping, a constant lr."""
    return ts.AdamW(lr=3e-3, weight_decay=0.0, b2=0.999, grad_clip=float("inf"),
                    warmup_steps=0, total_steps=10**9)


def test_port_adamw_matches_optax_adam():
    rng = np.random.default_rng(11)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal((5,)).astype(np.float32)},
              "s": np.float32(0.5)}
    jopt = optax.adam(3e-3)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    topt = _port_adam()
    tp = tl.params_from_jax(params)
    tstate = topt.init(tp)
    for _ in range(4):
        grads = jax.tree.map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update_([torch.from_numpy(np.asarray(g)) for g in _flat_jax(grads)], tstate, tp)
        for got, want in zip(ts._leaves(tp), _flat_jax(jp)):
            np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=1e-6)


def test_grpo_step_matches_jax():
    jcfg = _jcfg()
    jp = jl.llama_init(jcfg, jax.random.key(12))
    batch = _grpo_inputs(jp, jcfg, 13)
    grpo = dict(clip_eps=0.2, kl_coef=0.05)
    jopt = optax.adam(3e-3)
    jstate = js.TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=jopt.init(jp))
    jstep = jgrpo.make_grpo_step(jcfg, jopt, jgrpo.GRPOConfig(**grpo), donate=False)
    topt = _port_adam()
    params = tl.params_from_jax(jp)
    tstate = ts.TrainState(step=0, params=params, opt_state=topt.init(params))
    tstep = tgrpo.make_grpo_step(_tcfg(), topt, tgrpo.GRPOConfig(**grpo))
    tb = _to_torch(batch)
    with jax.default_matmul_precision("highest"):
        for i in range(2):
            jstate, jm = jstep(jstate, _to_jax(batch))
            tstate, tm = tstep(tstate, tb)
            assert set(tm) == set(jm) == {"loss", "pg_loss", "kl", "ratio_mean", "step"}
            for k in ("loss", "pg_loss", "kl", "ratio_mean"):
                _close(tm[k], jm[k])
            assert tm["step"] == int(jm["step"]) == i + 1
    assert tstate.opt_state.count == 2 and tstate.params is params
    _close_after_adam(tstate.params, jstate.params)


def test_ppo_step_matches_jax():
    jcfg = _jcfg()
    jp = jl.llama_init(jcfg, jax.random.key(14))
    jvh = jppo.init_value_head(jcfg, jax.random.key(15))
    batch = _ppo_batch(jp, jvh, jcfg, 16)
    ppo_kw = dict(entropy_coef=0.01)
    jopt = optax.adam(3e-3)
    jstate = js.TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=jopt.init(jp))
    jvh_opt = jopt.init(jvh)
    jstep = jppo.make_ppo_step(jcfg, jopt, jppo.PPOConfig(**ppo_kw), donate=False)
    topt = _port_adam()
    params, vh = tl.params_from_jax(jp), tppo.value_head_from_jax(jvh)
    tstate = ts.TrainState(step=0, params=params, opt_state=topt.init(params))
    tvh_opt = topt.init(vh)
    tstep = tppo.make_ppo_step(_tcfg(), topt, tppo.PPOConfig(**ppo_kw))
    tb = _to_torch(batch)
    with jax.default_matmul_precision("highest"):
        for _ in range(2):
            jstate, jvh, jvh_opt, jm = jstep(jstate, jvh, jvh_opt, _to_jax(batch))
            tstate, vh, tvh_opt, tm = tstep(tstate, vh, tvh_opt, tb)
            assert set(tm) == set(jm) == {"loss", "pg_loss", "value_loss", "entropy"}
            for k in tm:
                _close(tm[k], jm[k])
    assert tstate.step == 2 and tstate.opt_state.count == 2 and tvh_opt.count == 2
    _close_after_adam(tstate.params, jstate.params)
    _close_trees(vh, jvh)


# --------------------------------------------------------------------------- #
# GRPOTrainer
# --------------------------------------------------------------------------- #
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8]]
GROUP = 4


def _fixed_rollout(step):
    """The same completions in both trainers: G per prompt, ragged lengths,
    tokens from a seed (``step`` picks the draw)."""
    rng = np.random.default_rng(100 + step)
    outs = [rng.integers(0, 256, int(rng.integers(1, 7))).tolist()
            for _ in range(len(PROMPTS) * GROUP)]
    metas = [{"prompt_len": len(p)} for p in PROMPTS for _ in range(GROUP)]
    return outs, metas


def _reward(prompt, completion):
    return sum(1 for t in completion if t < 128) / max(1, len(completion))


@pytest.fixture(scope="module")
def trainers():
    """Both trainers from the same weights, two train_steps each on the same
    fixed completions (kl 0.05, 2 epochs a batch, default_optimizer at lr
    1e-3: update 0 runs at lr 0, so the policy moves from the second update
    on). The engines are greedy, for the serving check."""
    jcfg = _jcfg()
    jp = jl.llama_init(jcfg, jax.random.key(20))
    grpo = dict(group_size=GROUP, kl_coef=0.05, epochs_per_batch=2, temperature=0.0,
                max_new_tokens=6)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=100)
    jt = JTrainer(jcfg, _reward, grpo=jgrpo.GRPOConfig(**grpo),
                  optimizer=js.default_optimizer(**opt), params=jp, num_slots=2)
    tt = GRPOTrainer(_tcfg(), _reward, grpo=tgrpo.GRPOConfig(**grpo),
                     optimizer=ts.default_optimizer(**opt), params=tl.params_from_jax(jp),
                     num_slots=2, device="cpu")
    try:
        initial = ts._leaves(_clone(tt.state.params))
        metrics = []
        with jax.default_matmul_precision("highest"):
            for step in range(2):
                jt._rollout = tt._rollout = lambda prompts, s=step: _fixed_rollout(s)
                metrics.append((jt.train_step(PROMPTS), tt.train_step(PROMPTS)))
        yield {"jax": jt, "port": tt, "metrics": metrics, "initial": initial}
    finally:
        jt.stop()
        tt.stop()


def test_trainer_metrics_match_jax(trainers):
    for jm, tm in trainers["metrics"]:
        assert set(tm) == set(jm)
        for k in jm:
            _close(tm[k], jm[k])
    assert trainers["metrics"][1][1]["kl"] > 0  # the policy moved off the reference
    assert trainers["port"].state.step == 4 and trainers["port"].state.opt_state.count == 4


def test_trainer_params_match_jax(trainers):
    _close_after_adam(trainers["port"].state.params, trainers["jax"].state.params)


def test_trainer_reference_policy_is_frozen(trainers):
    """The update moved the policy in place; the reference copy kept every
    bit of the initial weights (an alias would have moved with it)."""
    tt = trainers["port"]
    now = ts._leaves(tt.state.params)
    assert any(not torch.equal(a, b) for a, b in zip(now, trainers["initial"]))
    for ref, init in zip(ts._leaves(tt._ref_params), trainers["initial"]):
        assert torch.equal(ref, init)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(now, ts._leaves(tt._ref_params)))


def test_trainer_engine_serves_the_updated_policy(trainers):
    tt = trainers["port"]
    prompt = [9, 8, 7, 6]
    got = tt.engine.generate(prompt, max_tokens=6, timeout=120)["tokens"]
    fresh = LLMEngine(_tcfg(), _clone(tt.state.params), device="cpu", num_slots=2)
    try:
        want = fresh.generate(prompt, max_tokens=6, timeout=120)["tokens"]
    finally:
        fresh.stop()
    assert got == want


def test_grpo_learns_toy_reward():
    """As tests/test_rl.py's learning run: reward = fraction of completion
    tokens equal to 7; a few GRPO iterations must raise it well above the
    ~1/256 uniform rate."""

    def reward(prompt, completion):
        if not completion:
            return 0.0
        return sum(1 for t in completion if t == 7) / len(completion)

    trainer = GRPOTrainer(
        _tcfg(), reward,
        grpo=tgrpo.GRPOConfig(group_size=4, max_new_tokens=8, temperature=1.0,
                              kl_coef=0.0, epochs_per_batch=2),
        optimizer=_port_adam(), num_slots=4, device="cpu")
    try:
        prompts = [[1, 2, 3], [4, 5, 6]]
        first = trainer.train_step(prompts)["reward_mean"]
        last = first
        for _ in range(12):
            last = trainer.train_step(prompts)["reward_mean"]
            if last > 0.5:
                break
        assert last > max(0.2, first + 0.1), (first, last)
    finally:
        trainer.stop()
    assert not trainer.engine._thread.is_alive()


def test_trainer_needs_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GRPOTrainer(_tcfg(), _reward)
