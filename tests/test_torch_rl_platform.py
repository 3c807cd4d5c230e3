"""Port parity, the RL platform: ray_tpu_torch.rl's envs, replay buffers,
env runners, DQN and IMPALA against ray_tpu.rl's on the CPU.

Numpy inputs come from a seed; the networks' parameters come from the JAX
package's inits, converted (``q_params_from_jax``, ``ac_params_from_jax``),
and everything runs in fp32 with the JAX matmuls at "highest" precision:

- envs give equal trajectories and buffers draw equal samples and weights
  for the same seeds (both are numpy);
- ``q_forward``, ``ac_forward`` and ``vtrace`` agree to 1e-5 (``vtrace``
  also with tests/test_rl_platform.py's brute force);
- one DQN update (double-Q on and off, with and without the prioritized
  buffer's weights) and one IMPALA update agree in loss, td and aux to
  1e-5; parameters after 10 updates are held by ``_close_after_adam``
  (tests/test_torch_rl.py);
- an ``EnvRunner.sample`` and a rollout-stream unroll, each package on its
  own ``LocalRuntime``, take the same actions (logits to 1e-5);
- tests/test_rl_platform.py's scenarios run on the port's runtime: runner
  fault tolerance, DQN and IMPALA learning the chain.
"""

import sys

import cloudpickle
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.rl import dqn as jdqn
from ray_tpu.rl import env as jenv
from ray_tpu.rl import env_runner as jrunner
from ray_tpu.rl import impala as jimpala
from ray_tpu.rl import replay_buffer as jbuf
from ray_tpu_torch.rl import dqn as tdqn
from ray_tpu_torch.rl import env as tenv
from ray_tpu_torch.rl import env_runner as trunner
from ray_tpu_torch.rl import impala as timpala
from ray_tpu_torch.rl import replay_buffer as tbuf
from ray_tpu_torch.train.step import adamw
from tests.test_torch_rl import _close_after_adam

TOL = 1e-5
CHAIN = {"n": 6, "max_steps": 20}


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _jax_tree(tree):
    """The JAX params with lists keyed like ``tdqn.as_tree``'s, for
    ``_close_after_adam``."""
    if isinstance(tree, (list, tuple)):
        return {f"{i:04d}": _jax_tree(v) for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _shutdown_all():
    for pkg in (ray_tpu, ray_tpu_torch):
        if pkg.is_initialized():
            pkg.shutdown()


@pytest.fixture
def runtimes():
    """Both packages' LocalRuntimes up (each keeps its own module-global
    worker); both shut down whatever happens."""
    _shutdown_all()
    ray_tpu.init(num_cpus=8)
    ray_tpu_torch.init(num_cpus=8)
    yield
    _shutdown_all()


@pytest.fixture
def port():
    _shutdown_all()
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    _shutdown_all()


# ------------------------------------------------------------------ envs
@pytest.mark.parametrize("name,kwargs", [("CartPole-rt", {}), ("CartPole-rt", {"max_steps": 30}),
                                         ("Chain-rt", CHAIN)])
def test_envs_give_the_same_trajectories(name, kwargs):
    envs = [pkg.make_env(name, **kwargs) for pkg in (jenv, tenv)]
    rng = np.random.default_rng(3)
    actions = rng.integers(0, 2, 200)
    traj = []
    for env in envs:
        obs, _ = env.reset(seed=11)
        rows = [obs]
        for a in actions:
            obs, r, term, trunc, _ = env.step(int(a))
            rows.append(np.concatenate([obs, [r, term, trunc]]))
            if term or trunc:
                obs, _ = env.reset()
                rows.append(obs)
        traj.append(rows)
    assert len(traj[0]) == len(traj[1])
    for a, b in zip(*traj):
        np.testing.assert_array_equal(a, b)
    assert type(envs[1]).__module__ == "ray_tpu_torch.rl.env"


def test_make_env_registry_and_missing_name(monkeypatch):
    tenv.register_env("Chain-short", lambda **kw: tenv.ChainEnv(n=3, **kw))
    assert tenv.make_env("Chain-short").n == 3
    monkeypatch.setitem(sys.modules, "gymnasium", None)  # gymnasium stays optional
    with pytest.raises(ValueError, match="unknown env"):
        tenv.make_env("NoSuchEnv-v0")


# ---------------------------------------------------------------- buffers
def _transitions(rng, n, obs_dim=3):
    return {"obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int64),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "next_obs": rng.standard_normal((n, obs_dim)).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32),
            "episodes": [], "worker_index": 0}


@pytest.mark.parametrize("prioritized", [False, True])
def test_buffers_draw_the_same_samples(prioritized):
    def make(mod):
        return (mod.PrioritizedReplayBuffer(100, alpha=0.7, beta=0.5, seed=4) if prioritized
                else mod.ReplayBuffer(100, seed=4))

    bufs = [make(jbuf), make(tbuf)]
    rng = np.random.default_rng(0)
    for _ in range(4):  # 4 x 40 rows into 100: the ring wraps
        batch = _transitions(rng, 40)
        td = rng.standard_normal(32) * 3
        for b in bufs:
            b.add_batch(batch)
        draws = [b.sample(32) for b in bufs]
        assert set(draws[0]) == set(draws[1])
        for k in draws[0]:
            np.testing.assert_array_equal(draws[0][k], draws[1][k])
        if prioritized:
            for b, d in zip(bufs, draws):
                b.update_priorities(d["indices"], td)
    assert len(bufs[0]) == len(bufs[1]) == 100


# ------------------------------------------------------------ the networks
def _q_params(obs_dim=4, hidden=(32, 32), seed=0):
    jp = jax.device_get(jdqn.q_init(obs_dim, 2, hidden, jax.random.key(seed)))
    return jp, tdqn.q_params_from_jax(jp, "cpu")


def _ac_params(obs_dim=4, hidden=(32, 32), seed=0, num_actions=2):
    jp = jax.device_get(jimpala.ac_init(obs_dim, num_actions, hidden, jax.random.key(seed)))
    return jp, timpala.ac_params_from_jax(jp, "cpu")


def _shapes(tree):
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


def test_inits_keep_the_layouts_and_scales():
    tq = tdqn.q_init(4, 2, (128, 128), seed=0, device="cpu")
    assert _shapes(tq) == _shapes(jdqn.q_init(4, 2, (128, 128), jax.random.key(0)))
    # He-normal: the weights' std near sqrt(2 / fan_in)
    assert abs(float(tq[1]["w"].std()) - (2.0 / 128) ** 0.5) < 0.01
    ta = timpala.ac_init(4, 2, (64,), seed=0, device="cpu")
    assert _shapes(ta) == _shapes(jimpala.ac_init(4, 2, (64,), jax.random.key(0)))
    assert float(ta["pi"]["w"].abs().max()) < 0.1
    # the same seed gives the same values (drawn on the CPU, for every device)
    again = tdqn.q_init(4, 2, (128, 128), seed=0, device="cpu")
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(tq, again))


def test_q_forward_and_ac_forward_match_jax():
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((16, 4)).astype(np.float32)
    jq, tq = _q_params()
    with jax.default_matmul_precision("highest"):
        want_q = jdqn.q_forward(jq, obs)
        ja, ta = _ac_params()
        want_logits, want_v = jimpala.ac_forward(ja, obs.reshape(4, 4, 4))
    _close(tdqn.q_forward(tq, obs), want_q)
    logits, v = timpala.ac_forward(ta, obs.reshape(4, 4, 4))
    _close(logits, want_logits)
    _close(v, want_v)


def _vtrace_inputs(seed, B=3, T=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T)).astype(np.float32) * 0.3,
            rng.standard_normal((B, T)).astype(np.float32) * 0.3,
            rng.standard_normal((B, T)).astype(np.float32),
            rng.standard_normal((B, T)).astype(np.float32),
            rng.standard_normal(B).astype(np.float32),
            (rng.random((B, T)) < 0.2).astype(np.float32))


def _vtrace_bruteforce(blogp, tlogp, rewards, values, bootstrap, dones, gamma, rho_bar, c_bar):
    """tests/test_rl_platform.py's loops over time (Espeholt '18 eq. (1))."""
    rho = np.minimum(np.exp(tlogp - blogp), rho_bar)
    c = np.minimum(np.exp(tlogp - blogp), c_bar)
    nd = 1.0 - dones
    v_next = np.concatenate([values[:, 1:], bootstrap[:, None]], 1)
    deltas = rho * (rewards + gamma * v_next * nd - values)
    vs = np.zeros_like(values)
    for b in range(values.shape[0]):
        acc = 0.0
        for t in reversed(range(values.shape[1])):
            acc = deltas[b, t] + gamma * nd[b, t] * c[b, t] * acc
            vs[b, t] = values[b, t] + acc
    vs_next = np.concatenate([vs[:, 1:], bootstrap[:, None]], 1)
    return vs, rho * (rewards + gamma * vs_next * nd - values)


@pytest.mark.parametrize("gamma,rho_bar,c_bar,T", [(0.95, 1.0, 1.0, 7), (0.99, 0.8, 1.2, 32)])
def test_vtrace_matches_jax_and_the_bruteforce(gamma, rho_bar, c_bar, T):
    inputs = _vtrace_inputs(0, T=T)
    vs, pg = timpala.vtrace(*map(torch.from_numpy, inputs), gamma, rho_bar, c_bar)
    jvs, jpg = jimpala.vtrace(*map(jnp.asarray, inputs), gamma, rho_bar, c_bar)
    bvs, bpg = _vtrace_bruteforce(*inputs, gamma, rho_bar, c_bar)
    _close(vs, jvs)
    _close(pg, jpg)
    _close(vs, bvs)
    _close(pg, bpg)
    assert not vs.requires_grad and not pg.requires_grad


# ---------------------------------------------------------------- updates
def _dqn_batch(rng, B=32, weights=True):
    batch = _transitions(rng, B, obs_dim=4)
    del batch["episodes"], batch["worker_index"]
    if weights:
        batch["weights"] = rng.uniform(0.1, 1.0, B).astype(np.float32)
    return batch


@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("weights", [True, False])
def test_dqn_update_matches_jax(double_q, weights):
    cfg = jdqn.DQNConfig(double_q=double_q, lr=1e-3)
    jp, tp = _q_params(seed=2)
    jt, tt = _q_params(seed=3)  # a target net that differs from the online one
    jupdate = jdqn.make_dqn_update(cfg, optax.adamw(cfg.lr))
    jopt = optax.adamw(cfg.lr).init(jp)
    opt = adamw(cfg.lr)
    tupdate = tdqn.make_dqn_update(tdqn.DQNConfig(double_q=double_q, lr=1e-3), opt)
    topt = opt.init(tdqn.as_tree(tp))
    rng = np.random.default_rng(5)
    for step in range(10):
        batch = _dqn_batch(rng, weights=weights)
        with jax.default_matmul_precision("highest"):
            jp, jopt, jloss, jtd = jupdate(jp, jt, jopt, batch)
        tp, topt, loss, td = tupdate(tp, tt, topt, batch)
        if step == 0:  # the first step from equal parameters: loss and td
            _close(loss, jloss)
            _close(td, jtd)
    _close_after_adam(tdqn.as_tree(tp), _jax_tree(jax.device_get(jp)))
    assert topt.count == 10 and not tp[0]["w"].requires_grad


def _impala_batch(rng, B=4, T=8, obs_dim=4, A=2):
    return {"obs": rng.standard_normal((B, T, obs_dim)).astype(np.float32),
            "next_obs_last": rng.standard_normal((B, obs_dim)).astype(np.float32),
            "actions": rng.integers(0, A, (B, T)).astype(np.int64),
            "rewards": rng.standard_normal((B, T)).astype(np.float32),
            "dones": (rng.random((B, T)) < 0.1).astype(np.float32),
            "behavior_logits": rng.standard_normal((B, T, A)).astype(np.float32) * 0.5}


def test_impala_update_matches_jax():
    cfg = jimpala.ImpalaConfig(lr=1e-3, rho_clip=1.0, c_clip=0.9)
    tcfg = timpala.ImpalaConfig(lr=1e-3, rho_clip=1.0, c_clip=0.9)
    jp, tp = _ac_params(hidden=(32, 32), seed=4)
    jupdate = jimpala.make_impala_update(cfg, optax.adamw(cfg.lr))
    jopt = optax.adamw(cfg.lr).init(jp)
    opt = adamw(tcfg.lr)
    tupdate = timpala.make_impala_update(tcfg, opt)
    topt = opt.init(tdqn.as_tree(tp))
    rng = np.random.default_rng(6)
    for step in range(10):
        batch = _impala_batch(rng)
        with jax.default_matmul_precision("highest"):
            jp, jopt, jloss, jaux = jupdate(jp, jopt, batch)
        tp, topt, loss, aux = tupdate(tp, topt, batch)
        if step == 0:
            _close(loss, jloss)
            assert set(aux) == set(jaux)
            for k in jaux:
                _close(aux[k], jaux[k])
    _close_after_adam(tdqn.as_tree(tp), _jax_tree(jax.device_get(jp)))


# ------------------------------------------------------------- the runners
def test_env_runner_sample_matches_jax(runtimes):
    jp, tp = _q_params(obs_dim=4, hidden=(16,), seed=7)
    out = []
    for pkg, runner_mod, policy, params in (
            (ray_tpu, jrunner, jdqn.make_policy_builder(), jp),
            (ray_tpu_torch, trunner, tdqn.make_policy_builder("cpu"), tp)):
        runner = runner_mod.EnvRunner.remote("CartPole-rt", policy, {"max_steps": 40},
                                             worker_index=1, seed=3)
        ref = pkg.put(params)
        out.append([pkg.get(runner.sample.remote(ref, 60, explore=0.3), timeout=60)
                    for _ in range(2)])
        pkg.kill(runner)
    for j, t in zip(*out):
        for k in ("obs", "actions", "rewards", "next_obs", "dones", "worker_index"):
            np.testing.assert_array_equal(t[k], j[k])
        assert t["episodes"] == j["episodes"]
    assert sum(len(s["episodes"]) for s in out[1]) >= 1  # 120 steps cross a 40-step cap


def test_rollout_stream_unroll_matches_jax(runtimes):
    kw = dict(env="CartPole-rt", env_config={"max_steps": 25}, hidden=(16,), unroll_len=20,
              seed=2)
    jp, tp = _ac_params(hidden=(16,), seed=8)
    ray_tpu.kv_put(jimpala.PARAMS_KEY, cloudpickle.dumps(jp))
    ray_tpu_torch.kv_put(timpala.PARAMS_KEY, cloudpickle.dumps(tp))
    jstream = jimpala._make_rollout_stream(jimpala.ImpalaConfig(**kw)).remote(0, 2)
    tstream = timpala._make_rollout_stream(timpala.ImpalaConfig(**kw), "cpu").remote(0, 2)
    with jax.default_matmul_precision("highest"):
        junrolls = [ray_tpu.get(ref, timeout=60) for ref in jstream]
    tunrolls = [ray_tpu_torch.get(ref, timeout=60) for ref in tstream]
    assert len(junrolls) == len(tunrolls) == 2
    for j, t in zip(junrolls, tunrolls):
        for k in ("obs", "next_obs_last", "actions", "rewards", "dones"):
            np.testing.assert_array_equal(t[k], j[k])
        _close(t["behavior_logits"], j["behavior_logits"])
        assert t["episodes"] == j["episodes"]


# ---------------------------------------- tests/test_rl_platform.py, on the port
def test_runner_group_fault_tolerance(port):
    group = trunner.EnvRunnerGroup("Chain-rt", tdqn.make_policy_builder("cpu"),
                                   num_runners=2, env_config={"n": 10}, seed=0)
    try:
        ref = port.put(tdqn.q_init(10, 2, (16,), seed=0, device="cpu"))
        batches = group.sample(ref, 32, explore=1.0)
        assert len(batches) == 2
        assert all(b["obs"].shape == (32, 10) for b in batches)
        # kill one runner behind the group's back: sample() must restart it
        # and still deliver both shares
        port.kill(group._runners[0])
        batches = group.sample(ref, 16, explore=1.0)
        assert len(batches) == 2
        assert sorted(b["worker_index"] for b in batches) == [0, 1]
    finally:
        group.stop()


def test_dqn_learns_chain(port):
    cfg = tdqn.DQNConfig(
        env="Chain-rt", env_config=CHAIN,
        hidden=(32,), num_runners=2, rollout_steps=64,
        buffer_capacity=5_000, learning_starts=128, batch_size=32,
        updates_per_iter=16, epsilon_decay_iters=10,
        target_sync_interval=4, seed=0,
    )
    trainer = tdqn.DQNTrainer(cfg, device="cpu")
    try:
        result = {}
        for _ in range(18):
            result = trainer.train()
        assert result["episode_return_mean"] is not None
        # optimal for n=6, 20 steps: reach end in 5 steps then 15*10 = 150
        assert result["episode_return_mean"] > 50, result
        assert result["loss"] is not None
        assert trainer.params[0]["w"].device.type == "cpu"
    finally:
        trainer.stop()


def test_impala_learns_chain_with_throughput(port):
    cfg = timpala.ImpalaConfig(
        env="Chain-rt", env_config=CHAIN,
        hidden=(32,), num_runners=2, unroll_len=20, batch_unrolls=4,
        entropy_coef=0.02, lr=3e-3, seed=0,
    )
    trainer = timpala.ImpalaTrainer(cfg, total_unrolls_per_runner=2_000, device="cpu")
    try:
        result = {}
        for _ in range(30):
            result = trainer.train()
        assert result["episode_return_mean"] is not None
        # optimal for n=6/20 steps ~150; pure-left policy ~2
        assert result["episode_return_mean"] > 30, result
        assert result["env_steps_per_s"] > 0
        assert np.isfinite(result["mean_rho"]) and result["mean_rho"] > 0
    finally:
        trainer.stop()


# ------------------------------------------------------- no silent fallback
def test_learners_without_a_device_need_the_card(port, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdqn.DQNTrainer(tdqn.DQNConfig(env="Chain-rt", env_config=CHAIN))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timpala.ImpalaTrainer(timpala.ImpalaConfig(env="Chain-rt", env_config=CHAIN))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdqn.make_policy_builder()


def test_rl_spread_measures_on_the_cpu(port):
    """``python -m ray_tpu_torch.rl_spread``'s two measurements, once each."""
    from ray_tpu_torch import rl_spread

    (run,) = rl_spread.learning_runs(1, "cpu")
    assert run["return"] is not None and np.isfinite(run["mean_rho"]) and run["seconds"] > 0
    assert rl_spread.update_alone_ms("cpu", calls=2) > 0
