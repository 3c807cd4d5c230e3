"""Port parity, parallelism: ray_tpu_torch.parallel (mesh, ring and Ulysses
attention, pipeline schedules, MoE) against ray_tpu.parallel, on 4 gloo
ranks.

One group of 4 ranks (tests/torch_mesh_ranks.py, spawned once for the
module, joined within its own timeout) runs every multi-rank case; the JAX
oracles run meanwhile in this process on ``jax.devices()[:4]`` with the same
``MeshConfig``, in fp32 at "highest" matmul precision, and each test holds
one case against them at tests/test_parallel.py's tolerances: attention
2e-5, pipeline loss rtol 1e-5 and grads atol 1e-5 rtol 1e-4, MoE 1e-4."""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from ray_tpu.ops.attention import reference_attention
from ray_tpu.parallel import expert as jexpert
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu.parallel.ring_attention import ring_attention_sharded as jring
from ray_tpu.parallel.ulysses import ulysses_attention_sharded as julysses
from ray_tpu_torch.parallel import expert as texpert
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, spec_placements

ATTN_TOL = 2e-5
CASES = ["ring_causal", "ring_noncausal", "ring_gqa", "ring_grads", "ulysses_causal",
         "ulysses_noncausal", "ulysses_gqa", "ulysses_indivisible", "pipeline_apply_pp4",
         "pipeline_train_gpipe", "pipeline_train_1f1b", "moe_dense_sharded", "moe_grads_sharded",
         "mesh_layouts", "dcn_dp_sum"]
MESH_LAYOUTS = {"hybrid": dict(dcn_dp=2, fsdp=2), "dcn_pp": dict(dcn_pp=2, pp=1, fsdp=2),
                "fsdp_tp": dict(fsdp=2, tp=2), "cp": dict(cp=4)}
PP, PIPE_D, TRAIN_D = 4, 16, 12


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _inputs():
    rng = np.random.default_rng(0)
    qkv = lambda r, hq, hkv, s, d, b=1: (_normal(r, (b, s, hq, d)), _normal(r, (b, s, hkv, d)),
                                         _normal(r, (b, s, hkv, d)))
    inp = {
        "ring_qkv": qkv(np.random.default_rng(0), 4, 4, 128, 32, b=2),
        "ring_cotangent": _normal(rng, (2, 128, 4, 32)),
        "ring_gqa_qkv": qkv(np.random.default_rng(1), 4, 2, 64, 16),
        "ulysses_qkv": qkv(np.random.default_rng(7), 8, 8, 128, 32, b=2),
        "ulysses_gqa_qkv": qkv(np.random.default_rng(8), 8, 4, 64, 16),
        "ulysses_bad_qkv": (np.zeros((1, 64, 2, 16), np.float32),) * 3,  # 2 heads, sp=4
        "mesh_layouts": MESH_LAYOUTS,
        "dcn_rows": np.arange(4.0, dtype=np.float32).reshape(4, 1),
    }
    r = np.random.default_rng(2)
    inp["pipe_apply"] = (_normal(r, (PP, PIPE_D, PIPE_D), 0.3), _normal(r, (PP, PIPE_D), 0.1),
                         _normal(r, (8, PIPE_D)))
    r = np.random.default_rng(9)
    inp["pipe_train"] = (_normal(r, (PP, TRAIN_D, TRAIN_D), 0.3), _normal(r, (PP, TRAIN_D), 0.1),
                         _normal(r, (16, TRAIN_D)), _normal(r, (16, TRAIN_D)))
    for key, (seed, e, xseed) in {"moe_dense": (0, 2, 3), "moe_grad": (2, 4, 5)}.items():
        r = np.random.default_rng(seed)
        inp[key] = {"params": {"router": _normal(r, (8, e), 8 ** -0.5),
                               "w_gate": _normal(r, (e, 8, 16), 8 ** -0.5),
                               "w_up": _normal(r, (e, 8, 16), 8 ** -0.5),
                               "w_down": _normal(r, (e, 16, 8), 16 ** -0.5)},
                    "x": _normal(np.random.default_rng(xseed), (2, 4, 8))}
    return inp


@pytest.fixture(scope="module")
def inputs():
    return _inputs()




def _jmesh(**axes):
    return jmesh.make_mesh(jmesh.MeshConfig(**axes), devices=jax.devices()[:4])


def _oracle_jobs(inputs):
    """name -> a thunk computing that JAX result."""
    J = lambda key: tuple(jnp.asarray(a) for a in inputs[key])
    jobs = {}
    for causal in (True, False):
        jobs[f"ring_{causal}"] = lambda c=causal: jring(*J("ring_qkv"), _jmesh(cp=4), causal=c)
        jobs[f"ulysses_{causal}"] = lambda c=causal: julysses(
            *J("ulysses_qkv"), _jmesh(sp=4), causal=c, axis_name="sp")
    jobs["ring_gqa"] = lambda: jring(*J("ring_gqa_qkv"), _jmesh(cp=2, tp=2), causal=True)
    jobs["ulysses_gqa"] = lambda: julysses(*J("ulysses_gqa_qkv"), _jmesh(sp=2, tp=2),
                                           causal=True, axis_name="sp")
    w = jnp.asarray(inputs["ring_cotangent"])
    jobs["ring_grads"] = lambda: jax.value_and_grad(
        lambda q, k, v: (jring(q, k, v, _jmesh(cp=4), causal=True) * w).sum(),
        argnums=(0, 1, 2))(*J("ring_qkv"))
    jobs["pipe_apply"] = lambda: jpipe.pipeline_apply(
        lambda p, x: jax.nn.relu(x @ p["w"] + p["b"]),
        dict(zip("wb", J("pipe_apply")[:2])), J("pipe_apply")[2], _jmesh(pp=4),
        num_microbatches=4)
    for schedule in ("gpipe", "1f1b"):
        jobs[f"pipe_{schedule}"] = lambda s=schedule: jpipe.pipeline_train_step(
            lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), lambda y, t: ((y - t) ** 2).mean(),
            dict(zip("wb", J("pipe_train")[:2])), *J("pipe_train")[2:], _jmesh(pp=4),
            num_microbatches=8, schedule=s)
    for key, cfg in (("moe_dense", jexpert.MoeConfig(num_experts=2, top_k=2,
                                                      capacity_factor=4.0)),
                     ("moe_grad", jexpert.MoeConfig(num_experts=4, top_k=2))):
        p = jax.tree.map(jnp.asarray, inputs[key]["params"])
        x = jnp.asarray(inputs[key]["x"])

        def loss(p, x=x, cfg=cfg):
            out, aux = jexpert.moe_apply(p, x, cfg)
            return (out ** 2).mean() + 0.01 * aux["moe_aux_loss"]

        jobs[key] = lambda p=p, x=x, cfg=cfg: jexpert.moe_apply(p, x, cfg)
        jobs[key + "_grads"] = lambda p=p, loss=loss: jax.value_and_grad(loss)(p)
    return jobs


@pytest.fixture(scope="module")
def run(inputs, tmp_path_factory):
    """(the rank group, the JAX package's results): the oracles are computed
    while the ranks run, in threads (each compiles apart)."""
    group = ranks.start(CASES, inputs, tmp_path_factory.mktemp("parallel_ranks"))

    def oracle(job):
        with jax.default_matmul_precision("highest"):
            return jax.block_until_ready(job())

    try:
        jobs = _oracle_jobs(inputs)
        with ThreadPoolExecutor(6) as pool:
            oracles = dict(zip(jobs, pool.map(oracle, jobs.values())))
        yield group, oracles
    finally:
        group.stop()


def _close(got, want, tol=ATTN_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _every_rank(group, name):
    return [group.value(name, r) for r in range(ranks.WORLD)]


# --------------------------------------------------------------------------- #
# Mesh and sharding
# --------------------------------------------------------------------------- #
def test_mesh_config_validation():
    mc = tmesh.MeshConfig(dp=2, fsdp=2, tp=2)
    assert mc.num_devices == jmesh.MeshConfig(dp=2, fsdp=2, tp=2).num_devices == 8
    with pytest.raises(ValueError):
        tmesh.MeshConfig(tp=3).validate(8)
    auto = tmesh.MeshConfig.auto(8, tp=2)
    assert auto.fsdp == 4 and auto.num_devices == 8
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    for kw in (dict(dp=2, fsdp=2, tp=2), dict(dcn_dp=2, fsdp=2, tp=2), dict(dcn_pp=2, fsdp=4)):
        assert tmesh.mesh_shape_for(tmesh.MeshConfig(**kw)) == jmesh.mesh_shape_for(
            jmesh.MeshConfig(**kw))


@pytest.mark.parametrize("kw", [dict(dcn_dp=2, fsdp=2, tp=2), dict(dcn_pp=2, fsdp=4),
                                dict(dcn_dp=2, dcn_pp=2, tp=2), dict(dp=2, fsdp=2, tp=2)])
def test_hybrid_mesh_rank_order(kw):
    """The ranks at every coordinate are the JAX mesh's device ids
    (slice-major: dp index 0 holds ranks 0-3 at dcn_dp=2)."""
    want = jmesh.make_mesh(jmesh.MeshConfig(**kw), devices=jax.devices()[:8]).devices
    got = tmesh.mesh_ranks(tmesh.MeshConfig(**kw), range(8))
    np.testing.assert_array_equal(got, np.vectorize(lambda d: d.id)(want))


def test_device_meshes_on_ranks_match_jax(run):
    """make_mesh on the 4 ranks: the axes of size > 1, in AXIS_ORDER, holding
    the JAX mesh's device ids; dcn_pp=2 makes the outer pp axis of size 2."""
    group, _ = run
    got = group.value("mesh_layouts")
    for name, kw in MESH_LAYOUTS.items():
        jm = jmesh.make_mesh(jmesh.MeshConfig(**kw), devices=jax.devices()[:4])
        keep = [n for n, s in zip(jm.axis_names, jm.devices.shape) if s > 1]
        assert got[name]["names"] == keep, name
        np.testing.assert_array_equal(
            got[name]["ranks"], np.vectorize(lambda d: d.id)(jm.devices).reshape(
                got[name]["ranks"].shape), err_msg=name)
    assert got["dcn_pp"]["names"][0] == "pp" and got["dcn_pp"]["ranks"].shape[0] == 2


def test_psum_over_dcn_dp_axis(run):
    """A sum over (dp, fsdp) spanning both virtual slices, against JAX's
    shard_map psum on the same mesh."""
    group, _ = run
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jmesh.make_mesh(jmesh.MeshConfig(dcn_dp=2, fsdp=2), devices=jax.devices()[:4])
    x = jnp.arange(4.0).reshape(4, 1)
    want = jax.jit(shard_map(lambda xs: jax.lax.psum(xs, axis_name=("dp", "fsdp")), mesh=mesh,
                             in_specs=P(("dp", "fsdp")), out_specs=P()))(
        jax.device_put(x, NamedSharding(mesh, P(("dp", "fsdp")))))
    for got in _every_rank(group, "dcn_dp_sum"):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_spec_placements_follow_the_rules():
    """Rules -> placements: a tuple of axes shards one dim over both mesh dims
    in the mesh's order; axes the mesh leaves out replicate; a repeated axis
    or an out-of-order tuple raises."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(ndim=3, mesh_dim_names=("dp", "fsdp", "tp"))
    assert DEFAULT_LLM_RULES.placements(mesh, ("batch", "seq", "act_embed")) == (
        Shard(0), Shard(0), Replicate())
    assert DEFAULT_LLM_RULES.placements(mesh, ("layers", "embed", "heads")) == (
        Replicate(), Shard(1), Shard(2))
    assert DEFAULT_LLM_RULES.placements(mesh, ("vocab", "embed")) == (
        Replicate(), Shard(1), Shard(0))
    with pytest.raises(ValueError, match="more than once"):
        spec_placements(mesh, ("fsdp", "fsdp"))
    with pytest.raises(ValueError, match="mesh order"):
        spec_placements(mesh, (("tp", "fsdp"),))
    with pytest.raises(ValueError, match="unknown mesh axis"):
        spec_placements(mesh, ("model",))


# --------------------------------------------------------------------------- #
# Ring and Ulysses attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(run, inputs, causal):
    group, oracles = run
    got = group.value("ring_causal" if causal else "ring_noncausal")
    _close(got, oracles[f"ring_{causal}"])
    q, k, v = (jnp.asarray(a) for a in inputs["ring_qkv"])
    with jax.default_matmul_precision("highest"):
        _close(got, reference_attention(q, k, v, causal=causal))


def test_ring_attention_gqa(run):
    group, oracles = run
    _close(group.value("ring_gqa"), oracles["ring_gqa"])


def test_ring_attention_gradients(run):
    """The K/V rotation's backward: dq, dk, dv through the ring at cp4."""
    group, oracles = run
    got = group.value("ring_grads")
    want_loss, want_grads = oracles["ring_grads"]
    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=1e-5)
    for g, w in zip(got["grads"], want_grads):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_attention_matches_jax(run, causal):
    group, oracles = run
    _close(group.value("ulysses_causal" if causal else "ulysses_noncausal"),
           oracles[f"ulysses_{causal}"])


def test_ulysses_gqa_matches_jax(run):
    group, oracles = run
    _close(group.value("ulysses_gqa"), oracles["ulysses_gqa"])


def test_ulysses_rejects_indivisible_heads(run):
    group, _ = run
    msg = group.value("ulysses_indivisible")["raised"]
    assert msg is not None and "divisible" in msg
    with pytest.raises(ValueError, match="divisible"):
        q = jnp.zeros((1, 64, 2, 16), jnp.float32)
        julysses(q, q, q, _jmesh(sp=4), axis_name="sp")


# --------------------------------------------------------------------------- #
# Pipeline
# --------------------------------------------------------------------------- #
def test_pipeline_apply_matches_jax(run):
    group, oracles = run
    _close(group.value("pipeline_apply_pp4"), oracles["pipe_apply"])


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_train_step_matches_jax(run, schedule):
    group, oracles = run
    got = group.value(f"pipeline_train_{schedule}")
    want_loss, want_grads = oracles[f"pipe_{schedule}"]
    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(got["grads"][k], np.asarray(want_grads[k]), atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pipeline_peak_stash(run, schedule):
    """The stash each stage really held: 1F1B's stage d holds at most
    2 (pp - 1 - d) + 1 inputs at once, within min(M, 2 pp - 1); GPipe's holds
    all M."""
    group, _ = run
    m = 8
    peaks = [r["peak_stash"] for r in _every_rank(group, f"pipeline_train_{schedule}")]
    bound = tpipe.stash_depth(schedule, PP, m)
    assert max(peaks) <= bound
    if schedule == "1f1b":
        assert bound == min(m, 2 * PP - 1) and peaks == [min(m, 2 * (PP - 1 - d) + 1)
                                                         for d in range(PP)]
    else:
        assert peaks == [m] * PP


def test_schedule_accounting():
    pp, m = 4, 16
    assert tpipe.stash_depth("1f1b", pp, m) == 2 * pp - 1
    assert tpipe.stash_depth("gpipe", pp, m) == m
    assert tpipe.stash_depth("1f1b", pp, 4) == 4
    assert tpipe.schedule_ticks("1f1b", pp, m) <= tpipe.schedule_ticks("gpipe", pp, m)
    assert tpipe.bubble_fraction("1f1b", pp, 64) < tpipe.bubble_fraction("1f1b", pp, 4) < 1.0
    for sched in ("gpipe", "1f1b"):
        for p in (1, 2, 4, 8):
            for mm in (1, 3, 8, 64):
                assert tpipe.schedule_ticks(sched, p, mm) == jpipe.schedule_ticks(sched, p, mm)
                assert tpipe.stash_depth(sched, p, mm) == jpipe.stash_depth(sched, p, mm)
                assert tpipe.bubble_fraction(sched, p, mm) == jpipe.bubble_fraction(sched, p, mm)
    with pytest.raises(ValueError):
        tpipe.schedule_ticks("zb", 4, 8)


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #
def test_moe_dense_equivalence_sharded(run, inputs):
    """top_k == num_experts and ample capacity at ep2 x fsdp2: the output is
    the softmax-weighted sum of both experts' FFNs, as JAX's moe_apply."""
    group, oracles = run
    got = group.value("moe_dense_sharded")
    want, aux = oracles["moe_dense"]
    np.testing.assert_allclose(got["out"], np.asarray(want), atol=1e-4, rtol=1e-4)
    p, x = inputs["moe_dense"]["params"], inputs["moe_dense"]["x"].reshape(-1, 8)
    logits = x @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    silu = lambda z: z / (1 + np.exp(-z))
    manual = sum(probs[:, e:e + 1] * ((silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e]))
                                      @ p["w_down"][e]) for e in range(2))
    np.testing.assert_allclose(got["out"].reshape(-1, 8), manual, atol=1e-4, rtol=1e-4)
    assert float(got["dropped"]) == float(aux["moe_dropped_fraction"]) == 0.0
    np.testing.assert_allclose(got["aux"], float(aux["moe_aux_loss"]), atol=1e-4, rtol=1e-4)


def test_moe_grads_sharded(run):
    group, oracles = run
    got = group.value("moe_grads_sharded")
    want_loss, want_grads = oracles["moe_grad_grads"]
    np.testing.assert_allclose(got["loss"], float(want_loss), atol=1e-4, rtol=1e-4)
    for k in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(got["grads"][k], np.asarray(want_grads[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)
    assert sum(float(np.abs(g).sum()) for g in got["grads"].values()) > 0


def test_moe_unsharded_matches_jax(run, inputs):
    """No mesh: the output, the aux metrics (with drops at capacity factor
    1.25) and every gradient."""
    _, oracles = run
    tp = texpert.moe_params_from_jax(inputs["moe_grad"]["params"])
    x = torch.from_numpy(inputs["moe_grad"]["x"])
    cfg = texpert.MoeConfig(num_experts=4, top_k=2)
    for p in tp.values():
        p.requires_grad_(True)
    out, aux = texpert.moe_apply(tp, x, cfg)
    want, want_aux = oracles["moe_grad"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert float(aux["moe_dropped_fraction"]) == pytest.approx(
        float(want_aux["moe_dropped_fraction"]), abs=1e-7)
    loss = (out ** 2).mean() + 0.01 * aux["moe_aux_loss"]
    grads = torch.autograd.grad(loss, [tp[k] for k in sorted(tp)])
    _, want_grads = oracles["moe_grad_grads"]
    for k, g in zip(sorted(tp), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_grads[k]), atol=1e-4, rtol=1e-4)


def test_moe_routing_breaks_ties_toward_the_lower_expert():
    """Equal router probabilities: the lower expert index wins, as in
    jax.lax.top_k, so buffer positions and drops match JAX's."""
    cfg_kw = dict(num_experts=4, top_k=2, capacity_factor=0.5)
    params = dict(_inputs()["moe_grad"]["params"])
    params["router"] = np.zeros_like(params["router"])  # every expert ties
    x = np.random.default_rng(6).standard_normal((2, 4, 8)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want, want_aux = jexpert.moe_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                           jexpert.MoeConfig(**cfg_kw))
    got, aux = texpert.moe_apply(texpert.moe_params_from_jax(params), torch.from_numpy(x),
                                 texpert.MoeConfig(**cfg_kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert float(aux["moe_dropped_fraction"]) == float(want_aux["moe_dropped_fraction"]) > 0
