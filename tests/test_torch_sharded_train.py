"""Port parity, the sharded train step: ray_tpu_torch's Llama train step under
a DeviceMesh against ray_tpu's under a jax.sharding.Mesh, on 4 gloo ranks.

One group of 4 ranks (tests/torch_mesh_ranks.py, spawned once for the
module, joined within its own timeout) runs every case from the JAX init of
``LlamaConfig.tiny`` (fp32); the JAX oracles run meanwhile in this process
on ``jax.devices()[:4]`` with the same ``MeshConfig``, at "highest" matmul
precision: the sharded train step at (dp2, tp2), (fsdp2, tp2), (fsdp4), on
two virtual slices (dcn_dp2 x fsdp2), and at (cp2, fsdp2), which trains
through ring attention. Tolerances: tests/test_model_llama.py's 1e-4 on the
loss; every gradient atol 1e-5, rtol 1e-4 (tests/test_torch_train.py);
every parameter after the Adam step by ``_close_after_adam``
(tests/test_torch_rl.py)."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from ray_tpu.models import llama as jl
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train import step as js
import optax
from ray_tpu.rl import grpo as jgrpo
from ray_tpu.rl import ppo as jppo
from test_torch_rl import _close_after_adam, _flat_jax, _grpo_inputs, _ppo_batch

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32, remat=None, attention_impl="reference")
OPT_KW = dict(lr=1e-2, warmup_steps=1, total_steps=50)
STEP_MESHES = {"dp2_tp2": dict(dp=2, tp=2), "fsdp2_tp2": dict(fsdp=2, tp=2),
               "fsdp4": dict(fsdp=4), "cp2_fsdp2": dict(cp=2, fsdp=2),
               "two_slices": dict(dcn_dp=2, fsdp=2)}
CASES = [f"llama_step_{n}" for n in STEP_MESHES] + [
    "llama_grads_cp2_fsdp2", "llama_placements", "llama_eval_fsdp2_tp2",
    "llama_save_attn_fsdp2_tp2", "grpo_step_fsdp2_tp2", "llama_heads_indivisible",
    "batch_shards", "llama_factory_fsdp2_tp2", "ppo_loss_fsdp2_tp2", "data_iter_sharded"]
PPO_KW = dict(entropy_coef=0.01)
GRPO_KW = dict(clip_eps=0.2, kl_coef=0.05)


def _jmesh(**axes):
    return jmesh.make_mesh(jmesh.MeshConfig(**axes), devices=jax.devices()[:4])


def _inputs():
    """The JAX inits (train state from key 0; GRPO policy from key 12) and
    the batches, as numpy."""
    jstate = js.make_train_state_factory(JCFG, js.default_optimizer(**OPT_KW))(jax.random.key(0))
    tokens = np.random.default_rng(2).integers(0, 256, (8, 64)).astype(np.int32)
    gp = jl.llama_init(JCFG, jax.random.key(12))
    pp, pvh = jl.llama_init(JCFG, jax.random.key(14)), jppo.init_value_head(JCFG, jax.random.key(15))
    return {"ppo_params": jax.tree.map(np.asarray, pp),
            "ppo_value_head": jax.tree.map(np.asarray, pvh),
            "ppo_batch": _ppo_batch(pp, pvh, JCFG, 16), "ppo_kw": PPO_KW,"llama_params": jax.tree.map(np.asarray, jstate.params), "opt_kw": OPT_KW,
            "llama_batch": (tokens, np.roll(tokens, -1, axis=1)),
            "grpo_params": jax.tree.map(np.asarray, gp), "grpo_batch": _grpo_inputs(gp, JCFG, 13),
            "grpo_kw": GRPO_KW, "batch_rows": np.arange(24.0, dtype=np.float32).reshape(8, 3),
            "data_rows": np.random.default_rng(4).standard_normal((16, 3)).astype(np.float32),
            # optax.adam(3e-3): no weight decay, b2 0.999, no clipping, constant lr
            "grpo_opt_kw": dict(lr=3e-3, weight_decay=0.0, b2=0.999, grad_clip=float("inf"),
                                warmup_steps=0, total_steps=10**9)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    inputs = _inputs()
    group = ranks.start(CASES, inputs, tmp_path_factory.mktemp("sharded_train_ranks"))
    tt, tg = (jnp.asarray(a) for a in inputs["llama_batch"])
    jp = jax.tree.map(jnp.asarray, inputs["llama_params"])
    jobs = {}
    for name, axes in STEP_MESHES.items():
        def step(axes=axes):
            opt = js.default_optimizer(**OPT_KW)
            mesh = _jmesh(**axes)
            state = js.make_train_state_factory(JCFG, opt, mesh=mesh)(jax.random.key(0))
            return (state,) + js.make_train_step(JCFG, opt, mesh=mesh, donate=False)(state, tt, tg)
        jobs[name] = step
    mesh = _jmesh(cp=2, fsdp=2)
    jobs["grads_cp2_fsdp2"] = lambda: jax.value_and_grad(
        lambda p: jl.llama_loss(p, tt, tg, JCFG, mesh=mesh))(jp)
    jobs["eval"] = lambda: js.make_eval_step(JCFG, mesh=_jmesh(fsdp=2, tp=2))(jp, tt, tg)

    def grpo():
        jopt = optax.adam(3e-3)
        gp = jax.tree.map(jnp.asarray, inputs["grpo_params"])
        state = js.TrainState(step=jnp.zeros((), jnp.int32), params=gp, opt_state=jopt.init(gp))
        step = jgrpo.make_grpo_step(JCFG, jopt, jgrpo.GRPOConfig(**GRPO_KW),
                                    mesh=_jmesh(fsdp=2, tp=2), donate=False)
        batch = {k: jnp.asarray(v) for k, v in inputs["grpo_batch"].items()}
        metrics = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics.append(m)
        return state, metrics

    jobs["grpo"] = grpo

    def ppo():
        p = jax.tree.map(jnp.asarray, inputs["ppo_params"])
        vh = jax.tree.map(jnp.asarray, inputs["ppo_value_head"])
        batch = {k: jnp.asarray(v) for k, v in inputs["ppo_batch"].items()}
        mesh = _jmesh(fsdp=2, tp=2)
        out = jax.value_and_grad(
            lambda p, vh: jppo.ppo_loss(p, vh, batch, JCFG, jppo.PPOConfig(**PPO_KW), mesh=mesh),
            argnums=(0, 1), has_aux=True)(p, vh)
        return out, jppo.value_estimates(p, vh, batch["tokens"], JCFG, mesh=mesh)

    jobs["ppo"] = ppo

    def oracle(job):
        with jax.default_matmul_precision("highest"):
            return jax.block_until_ready(job())

    try:
        with ThreadPoolExecutor(6) as pool:
            oracles = dict(zip(jobs, pool.map(oracle, jobs.values())))
        yield group, oracles, inputs
    finally:
        group.stop()


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


@pytest.mark.parametrize("name", list(STEP_MESHES))
def test_sharded_train_step_matches_jax(run, name):
    """One step from the same init: the loss, the global gradient norm (of
    the whole gradients, not of a shard) and every parameter after the
    update, against the JAX package's step on the same mesh."""
    group, oracles, _ = run
    got = group.value(f"llama_step_{name}")
    _, jstate, jm = oracles[name]
    assert abs(float(got["loss"]) - float(jm["loss"])) < 1e-4, (got["loss"], jm["loss"])
    np.testing.assert_allclose(float(got["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    _close_after_adam(_torch_tree(got["params"]), jstate.params)
    # the moments keep their parameter's layout
    assert got["mu_placements"] == got["placements"]["wq"]


def test_cp_train_grads_through_ring_attention(run):
    """(cp2, fsdp2): the sequence is split, so the layers' attention is the
    ring; the loss and every gradient against JAX's llama_loss on the same
    mesh."""
    group, oracles, _ = run
    got = group.value("llama_grads_cp2_fsdp2")
    jloss, jgrads = oracles["grads_cp2_fsdp2"]
    assert abs(float(got["loss"]) - float(jloss)) < 1e-4
    want = _flat_jax(jgrads)
    assert len(got["grads"]) == len(want)
    for g, w in zip(got["grads"], want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)


def test_param_placements_applied(run):
    """fsdp2 x tp2: wq (layers, embed, heads) is (fsdp: Shard(1), tp: Shard(2)),
    embed_tokens (vocab, embed) is (fsdp: Shard(1), tp: Shard(0)), wq's
    moment takes wq's, and every parameter and moment has the placements of
    ``_state_shardings``; each rank's shard is the JAX array's shard on the
    device at the same mesh coordinate."""
    group, oracles, _ = run
    jstate = oracles["fsdp2_tp2"][0]
    for rank in range(ranks.WORLD):
        got = group.value("llama_placements", rank)
        assert got["names"] == ["fsdp", "tp"]
        assert got["wq"] == "(Shard(dim=1), Shard(dim=2))", got["wq"]
        assert got["embed"] == "(Shard(dim=1), Shard(dim=0))", got["embed"]
        assert got["mu_wq"] == got["wq"]
        assert got["every_leaf_as_state_shardings"]
        for key, arr in (("wq_local", jstate.params["layers"]["wq"]),
                         ("embed_local", jstate.params["embed_tokens"])):
            shard, = [s for s in arr.addressable_shards if s.device.id == rank]
            np.testing.assert_array_equal(got[key], np.asarray(shard.data))
    assert jstate.params["layers"]["wq"].sharding.spec == jax.sharding.PartitionSpec(
        None, "fsdp", "tp")


def test_sharded_eval_step_matches_jax(run):
    group, oracles, _ = run
    assert abs(float(group.value("llama_eval_fsdp2_tp2")) - float(oracles["eval"])) < 1e-5


def test_save_attn_keeps_the_flash_op_under_a_mesh(run):
    """The remat policy sees the flash op inside local_map: save_attn runs
    the attention forward once a layer, as remat None does, with the same
    loss and gradients."""
    group, _, _ = run
    got = group.value("llama_save_attn_fsdp2_tp2")
    layers = JCFG.num_layers
    assert got["None"]["calls"] == got["save_attn"]["calls"] == layers
    assert abs(float(got["None"]["loss"]) - float(got["save_attn"]["loss"])) < 1e-6
    for a, b in zip(got["None"]["grads"], got["save_attn"]["grads"]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_sharded_grpo_step_matches_jax(run):
    """Two GRPO steps at fsdp2 x tp2 against ray_tpu.rl's make_grpo_step on
    the same mesh: every metric of each step, then every parameter."""
    group, oracles, _ = run
    got = group.value("grpo_step_fsdp2_tp2")
    jstate, jmetrics = oracles["grpo"]
    for m, jm in zip(got["metrics"], jmetrics):
        assert m["step"] == int(jm["step"])
        for k in ("loss", "pg_loss", "kl", "ratio_mean"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-5, rtol=1e-4,
                                       err_msg=k)
    _close_after_adam(_torch_tree(got["params"]), jstate.params)


def test_attention_raises_where_tp_splits_gqa_groups(run):
    """tp4 over tiny's 2 kv heads: raised, as each rank must keep whole GQA
    groups for the flash op; no plain fallback."""
    group, _, _ = run
    msg = group.value("llama_heads_indivisible")["raised"]
    assert msg is not None and "whole GQA groups" in msg


def test_batch_rows_land_where_jax_puts_them(run):
    """batch_sharding_spec over dp2 x fsdp2: each rank holds the rows of the
    JAX array's shard on the device at its mesh coordinate (dp major, fsdp
    minor); 6 rows over 4 shards, where DTensor's nested chunks (2, 1, 2, 1)
    would differ from JAX's (2, 2, 2, 0), is refused."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    group, _, inputs = run
    mesh = _jmesh(dp=2, fsdp=2)
    arr = jax.device_put(jnp.asarray(inputs["batch_rows"]), NamedSharding(mesh, P(("dp", "fsdp"))))
    for rank in range(ranks.WORLD):
        got = group.value("batch_shards", rank)
        shard, = [s for s in arr.addressable_shards if s.device.id == rank]
        np.testing.assert_array_equal(got["local"], np.asarray(shard.data))
        assert got["raised"] is not None and "does not divide" in got["raised"]


def test_iter_torch_batches_shards_where_iter_jax_batches_puts_them(run):
    """``iter_torch_batches(sharding=(mesh, placements))`` on dp2 x fsdp2: each
    rank holds, of every batch, the rows of the shard that
    ``ray_tpu.data``'s ``iter_jax_batches(sharding=NamedSharding(...))`` puts
    on the device at its mesh coordinate."""
    import ray_tpu
    from jax.sharding import NamedSharding, PartitionSpec as P
    from ray_tpu import data as jrd

    group, _, inputs = run
    sharding = NamedSharding(_jmesh(dp=2, fsdp=2), P(("dp", "fsdp")))
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()
    ray_tpu.init(num_cpus=2)
    try:
        want = list(jrd.from_numpy({"x": inputs["data_rows"]}).iter_jax_batches(
            batch_size=8, sharding=sharding))
    finally:
        ray_tpu.shutdown()
    assert len(want) == 2
    for rank in range(ranks.WORLD):
        got = group.value("data_iter_sharded", rank)
        assert len(got) == len(want)
        for local, batch in zip(got, want):
            shard, = [s for s in batch["x"].addressable_shards if s.device.id == rank]
            np.testing.assert_array_equal(local, np.asarray(shard.data))


def test_sharded_factory_holds_the_unsharded_init(run):
    """The sharded init from a seed holds the unsharded init's values from the
    same seed, its moments zero, its counts 0."""
    group, _, _ = run
    got = group.value("llama_factory_fsdp2_tp2")
    assert got["max_diff"] == 0.0 and got["n_leaves"] == 12
    assert got["count"] == 0 and got["step"] == 0


def test_sharded_ppo_loss_matches_jax(run):
    """PPO at fsdp2 x tp2: the loss, its metrics, every gradient of the policy
    and of the (plain, replicated) value head, and value_estimates, against
    ray_tpu.rl.ppo on the same mesh (tests/test_torch_rl.py's tolerances)."""
    group, oracles, _ = run
    got = group.value("ppo_loss_fsdp2_tp2")
    ((jloss, jaux), (jg, jvg)), jvalues = oracles["ppo"]
    np.testing.assert_allclose(float(got["loss"]), float(jloss), atol=1e-5, rtol=1e-4)
    for k in ("pg_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(got["aux"][k]), float(jaux[k]), atol=1e-5, rtol=1e-4)
    want = _flat_jax(jg) + _flat_jax(jvg)
    assert len(got["grads"]) == len(want)
    for g, w in zip(got["grads"], want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got["values"], np.asarray(jvalues), atol=1e-5, rtol=1e-4)
