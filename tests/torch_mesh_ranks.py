"""Runs the port's mesh cases on several gloo ranks, for
tests/test_torch_parallel.py and tests/test_torch_sharded_train.py.

A test module starts one group of ranks (``start``), computes its JAX
oracles meanwhile, then reads every rank's results (``RankGroup.results``).
Each rank runs every named case of ``CASES`` in the same order and records
what it returns (numpy arrays and numbers), or the traceback of what it
raised, so one failing case fails only its own tests. The ranks meet
through a ``FileStore`` under the test's tmp dir (no TCP port: several test
workers run at once), their collectives time out after
``COLLECTIVE_TIMEOUT_S``, and ``results`` kills the group and fails when
it has not finished within its join timeout, so a hung collective never
outlasts its test.

This module imports torch and the port only: the ranks never load JAX. The
inputs (numpy, some of them weights from the JAX package) come from the
test process through a pickle that it writes itself. On a machine with 4
cards the same cases run on NCCL, one card a rank (``start(...,
device="cuda")``); the tests here use gloo on the CPU.
"""

from __future__ import annotations

import datetime
import os
import pickle
import time
import traceback
from typing import Any, Callable, Dict, List

WORLD = 4
COLLECTIVE_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 120.0

CASES: Dict[str, Callable[[Dict[str, Any]], Any]] = {}
DEVICE = "cpu"  # this rank's device type, set by _rank_main


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def numpy_tree(tree):
    """DTensors as their full values, tensors as numpy, through dicts,
    lists and tuples."""
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(numpy_tree(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.full_tensor()
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return tree


def _rank_main(rank: int, world: int, store_path: str, inputs_path: str, out_path: str,
               names: List[str], device: str) -> None:
    import torch
    import torch.distributed as dist

    global DEVICE
    DEVICE = device
    # ranks share the host with each other (and with other test workers)
    torch.set_num_threads(1)
    if device == "cuda":  # one card a rank
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.FileStore(store_path, world), rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    results = {}
    for name in names:
        t0 = time.perf_counter()
        try:
            results[name] = {"value": numpy_tree(CASES[name](inputs))}
        except Exception:  # noqa: BLE001 - recorded and failed by the test of this case
            results[name] = {"error": traceback.format_exc()}
        results[name]["seconds"] = time.perf_counter() - t0
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(results, f)
    os.replace(out_path + ".tmp", out_path)
    dist.destroy_process_group()


class RankGroup:
    def __init__(self, procs, out_paths, deadline):
        self.procs, self.out_paths, self.deadline = procs, out_paths, deadline
        self._results = None

    def results(self) -> List[Dict[str, Any]]:
        """Every rank's {case: {"value" or "error", "seconds"}}, rank order."""
        if self._results is None:
            for p in self.procs:
                p.join(max(0.0, self.deadline - time.monotonic()))
            alive = [p.pid for p in self.procs if p.is_alive()]
            self.stop()
            if alive:
                raise TimeoutError(f"ranks {alive} did not finish within {JOIN_TIMEOUT_S} s")
            codes = [p.exitcode for p in self.procs]
            if any(codes):
                raise RuntimeError(f"ranks exited with codes {codes}")
            self._results = []
            for path in self.out_paths:
                with open(path, "rb") as f:
                    self._results.append(pickle.load(f))
        return self._results

    def stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)

    def value(self, name: str, rank: int = 0):
        got = self.results()[rank][name]
        if "error" in got:
            raise AssertionError(f"case {name} failed on rank {rank}:\n{got['error']}")
        return got["value"]


def start(names: List[str], inputs: Dict[str, Any], tmp_dir, world: int = WORLD,
          device: str = "cpu") -> RankGroup:
    """Spawn ``world`` ranks running the cases ``names`` on ``inputs``: gloo
    on the CPU, or (``device="cuda"``, a machine with ``world`` cards) NCCL
    with one card a rank."""
    import multiprocessing

    tmp_dir = str(tmp_dir)
    inputs_path = os.path.join(tmp_dir, "inputs.pkl")
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)
    store_path = os.path.join(tmp_dir, "store")
    ctx = multiprocessing.get_context("spawn")
    out_paths = [os.path.join(tmp_dir, f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, store_path, inputs_path, out_paths[r], names, device))
             for r in range(world)]
    for p in procs:
        p.start()
    return RankGroup(procs, out_paths, time.monotonic() + JOIN_TIMEOUT_S)


# --------------------------------------------------------------------------- #
# Cases. Each runs on every rank; ``inputs`` holds numpy arrays.
# --------------------------------------------------------------------------- #
def _t(a):
    import torch

    return torch.from_numpy(a.copy()).to(DEVICE)


def _mesh(**axes):
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    return make_mesh(MeshConfig(**axes), device_type=DEVICE)


def _attention_case(fn_name, key, inputs, axes, causal):
    from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    fn = {"ring": ring_attention_sharded, "ulysses": ulysses_attention_sharded}[fn_name]
    q, k, v = (_t(a) for a in inputs[key])
    extra = {} if fn_name == "ring" else {"axis_name": "sp"}
    return fn(q, k, v, _mesh(**axes), causal=causal, **extra)


@case
def ring_causal(inputs):
    return _attention_case("ring", "ring_qkv", inputs, {"cp": 4}, True)


@case
def ring_noncausal(inputs):
    return _attention_case("ring", "ring_qkv", inputs, {"cp": 4}, False)


@case
def ring_gqa(inputs):
    return _attention_case("ring", "ring_gqa_qkv", inputs, {"cp": 2, "tp": 2}, True)


@case
def ring_grads(inputs):
    """Loss sum(out * w) through ring attention at cp4: gradients of q, k, v
    (the K/V rotation's backward)."""
    import torch

    from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded

    q, k, v = (_t(a).requires_grad_(True) for a in inputs["ring_qkv"])
    mesh = _mesh(cp=4)
    from ray_tpu_torch.parallel.sharding import shard_tensor, spec_placements

    pl = spec_placements(mesh, (None, "cp", None, None))
    dq, dk, dv = (shard_tensor(t, mesh, pl) for t in (q, k, v))
    for t in (dq, dk, dv):
        t.requires_grad_(True)
    out = ring_attention_sharded(dq, dk, dv, mesh, causal=True)
    w = shard_tensor(_t(inputs["ring_cotangent"]), mesh, pl)
    loss = (out * w).sum()
    grads = torch.autograd.grad(loss, (dq, dk, dv))
    return {"loss": loss.full_tensor(), "grads": list(grads)}


@case
def ulysses_causal(inputs):
    return _attention_case("ulysses", "ulysses_qkv", inputs, {"sp": 4}, True)


@case
def ulysses_noncausal(inputs):
    return _attention_case("ulysses", "ulysses_qkv", inputs, {"sp": 4}, False)


@case
def ulysses_gqa(inputs):
    return _attention_case("ulysses", "ulysses_gqa_qkv", inputs, {"sp": 2, "tp": 2}, True)


@case
def ulysses_indivisible(inputs):
    try:
        _attention_case("ulysses", "ulysses_bad_qkv", inputs, {"sp": 4}, True)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def _stage_fns(kind):
    import torch

    if kind == "relu":
        return lambda p, x: torch.relu(x @ p["w"] + p["b"])
    return lambda p, x: torch.tanh(x @ p["w"] + p["b"])


@case
def pipeline_apply_pp4(inputs):
    from ray_tpu_torch.parallel.pipeline import pipeline_apply

    w, b, x = (_t(a) for a in inputs["pipe_apply"])
    return pipeline_apply(_stage_fns("relu"), {"w": w, "b": b}, x, _mesh(pp=4),
                          num_microbatches=4)


def _pipeline_train(inputs, schedule):
    from ray_tpu_torch.parallel.pipeline import pipeline_train_step

    w, b, x, tgt = (_t(a) for a in inputs["pipe_train"])
    stats = {}
    loss, grads = pipeline_train_step(
        _stage_fns("tanh"), lambda y, t: ((y - t) ** 2).mean(), {"w": w, "b": b}, x, tgt,
        _mesh(pp=4), num_microbatches=8, schedule=schedule, stats=stats)
    return {"loss": loss, "grads": grads, "peak_stash": stats["peak_stash"]}


@case
def pipeline_train_gpipe(inputs):
    return _pipeline_train(inputs, "gpipe")


@case
def pipeline_train_1f1b(inputs):
    return _pipeline_train(inputs, "1f1b")


def _moe(inputs, key, cfg_kw, grads):
    import torch

    from ray_tpu_torch.parallel.expert import (MoeConfig, moe_apply, moe_logical_axes,
                                               moe_params_from_jax)
    from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, shard_pytree

    mesh = _mesh(ep=2, fsdp=2)
    params = shard_pytree(moe_params_from_jax(inputs[key]["params"], DEVICE), moe_logical_axes(), mesh,
                          DEFAULT_LLM_RULES)
    x = _t(inputs[key]["x"])
    cfg = MoeConfig(**cfg_kw)
    if not grads:
        out, aux = moe_apply(params, x, cfg, mesh=mesh, rules=DEFAULT_LLM_RULES)
        return {"out": out, "dropped": aux["moe_dropped_fraction"], "aux": aux["moe_aux_loss"]}
    leaves = [params[k] for k in sorted(params)]
    for p in leaves:
        p.requires_grad_(True)
    out, aux = moe_apply(params, x, cfg, mesh=mesh, rules=DEFAULT_LLM_RULES)
    loss = (out ** 2).mean() + 0.01 * aux["moe_aux_loss"]
    g = torch.autograd.grad(loss, leaves)
    return {"loss": loss, "grads": dict(zip(sorted(params), g))}


@case
def moe_dense_sharded(inputs):
    return _moe(inputs, "moe_dense", dict(num_experts=2, top_k=2, capacity_factor=4.0), False)


@case
def moe_grads_sharded(inputs):
    return _moe(inputs, "moe_grad", dict(num_experts=4, top_k=2), True)


@case
def mesh_layouts(inputs):
    """Each config's DeviceMesh: its dim names and the rank at every
    coordinate."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    out = {}
    for name, kw in inputs["mesh_layouts"].items():
        mesh = make_mesh(MeshConfig(**kw), device_type=DEVICE)
        out[name] = {"names": list(mesh.mesh_dim_names), "ranks": mesh.mesh.numpy()}
    return out


@case
def dcn_dp_sum(inputs):
    """A data-parallel reduction spanning both virtual slices: rows sharded
    over (dp, fsdp), summed over both axes."""
    from torch.distributed.tensor import DTensor, Partial

    from ray_tpu_torch.parallel.mesh import batch_sharding_spec, make_mesh, MeshConfig
    from ray_tpu_torch.parallel.sharding import shard_tensor, spec_placements

    mesh = make_mesh(MeshConfig(dcn_dp=2, fsdp=2), device_type=DEVICE)
    x = shard_tensor(_t(inputs["dcn_rows"]), mesh, spec_placements(mesh, batch_sharding_spec()[:1]))
    summed = DTensor.from_local(x.to_local(), mesh, [Partial()] * mesh.ndim, run_check=False)
    return summed.full_tensor()


# --------------------------------------------------------------------------- #
# Sharded Llama train step (tests/test_torch_sharded_train.py)
# --------------------------------------------------------------------------- #
def _llama_cfg(**kw):
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig

    kw.setdefault("remat", None)
    return LlamaConfig.tiny(dtype=torch.float32, **kw)


def _sharded_state(inputs, mesh):
    from ray_tpu_torch.models.llama import params_from_jax
    from ray_tpu_torch.train.step import TrainState, default_optimizer, shard_train_state

    opt = default_optimizer(**inputs["opt_kw"])
    params = params_from_jax(inputs["llama_params"], DEVICE)
    return opt, shard_train_state(TrainState(step=0, params=params, opt_state=opt.init(params)),
                                  mesh)


def _llama_step(inputs, **axes):
    """One sharded train step from the JAX init: loss, grad norm, and every
    parameter after the update."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.train.step import make_train_step

    mesh = make_mesh(MeshConfig(**axes), device_type=DEVICE)
    opt, state = _sharded_state(inputs, mesh)
    tokens, targets = (_t(a) for a in inputs["llama_batch"])
    state, metrics = make_train_step(_llama_cfg(), opt, mesh=mesh)(state, tokens, targets)
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"], "params": state.params,
            "mu_placements": str(state.opt_state.mu["layers"]["wq"].placements),
            "placements": {k: str(v.placements) for k, v in state.params["layers"].items()}}


@case
def llama_step_dp2_tp2(inputs):
    return _llama_step(inputs, dp=2, tp=2)


@case
def llama_step_fsdp2_tp2(inputs):
    return _llama_step(inputs, fsdp=2, tp=2)


@case
def llama_step_fsdp4(inputs):
    return _llama_step(inputs, fsdp=4)


@case
def llama_step_cp2_fsdp2(inputs):
    return _llama_step(inputs, cp=2, fsdp=2)


@case
def llama_step_two_slices(inputs):
    return _llama_step(inputs, dcn_dp=2, fsdp=2)


@case
def llama_grads_cp2_fsdp2(inputs):
    """Loss and every gradient through ring attention (cp2 x fsdp2), in the
    parameters' placements."""
    import torch

    from ray_tpu_torch.models.llama import llama_loss
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.train.step import _leaves

    mesh = make_mesh(MeshConfig(cp=2, fsdp=2), device_type=DEVICE)
    _, state = _sharded_state(inputs, mesh)
    leaves = _leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    tokens, targets = (_t(a).long() for a in inputs["llama_batch"])
    loss = llama_loss(state.params, tokens, targets, _llama_cfg(), mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    return {"loss": loss, "grads": [g.redistribute(p.device_mesh, p.placements)
                                    for g, p in zip(grads, leaves)]}


@case
def llama_placements(inputs):
    """At fsdp2 x tp2: the placements of wq, embed_tokens and wq's first
    moment, and this rank's local shards of wq and embed_tokens."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES
    from ray_tpu_torch.train.step import _leaves, _state_shardings, state_logical_axes

    mesh = make_mesh(MeshConfig(fsdp=2, tp=2), device_type=DEVICE)
    _, state = _sharded_state(inputs, mesh)
    wq, emb = state.params["layers"]["wq"], state.params["embed_tokens"]
    want = _state_shardings(state_logical_axes(_llama_cfg()), mesh, DEFAULT_LLM_RULES)
    every = all(tuple(t.placements) == tuple(p) for tree, ptree in (
        (state.params, want.params), (state.opt_state.mu, want.opt_state.mu),
        (state.opt_state.nu, want.opt_state.nu)) for t, p in zip(_leaves(tree), _leaves(ptree)))
    return {"names": list(mesh.mesh_dim_names), "wq": str(wq.placements),
            "every_leaf_as_state_shardings": every,
            "embed": str(emb.placements),
            "mu_wq": str(state.opt_state.mu["layers"]["wq"].placements),
            "wq_local": wq.to_local(), "embed_local": emb.to_local()}


@case
def llama_eval_fsdp2_tp2(inputs):
    from ray_tpu_torch.models.llama import params_from_jax
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, shard_pytree
    from ray_tpu_torch.models.llama import llama_logical_axes
    from ray_tpu_torch.train.step import make_eval_step

    mesh = make_mesh(MeshConfig(fsdp=2, tp=2), device_type=DEVICE)
    cfg = _llama_cfg()
    params = shard_pytree(params_from_jax(inputs["llama_params"], DEVICE), llama_logical_axes(cfg), mesh,
                          DEFAULT_LLM_RULES)
    tokens, targets = (_t(a) for a in inputs["llama_batch"])
    return make_eval_step(cfg, mesh=mesh)(params, tokens, targets)


@case
def llama_save_attn_fsdp2_tp2(inputs):
    """remat save_attn under a mesh: the flash op is pinned inside local_map
    (one plain lse forward a layer), with the loss and gradients of remat None."""
    from unittest import mock

    import torch

    import ray_tpu_torch.ops.attention as ta
    from ray_tpu_torch.models.llama import llama_loss
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.train.step import _leaves

    mesh = make_mesh(MeshConfig(fsdp=2, tp=2), device_type=DEVICE)
    _, state = _sharded_state(inputs, mesh)
    leaves = _leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    tokens, targets = (_t(a).long() for a in inputs["llama_batch"])
    out, calls = {}, []
    real = ta.reference_attention_lse

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    for remat in (None, "save_attn"):
        calls.clear()
        with mock.patch.object(ta, "reference_attention_lse", counting):
            loss = llama_loss(state.params, tokens, targets, _llama_cfg(remat=remat), mesh=mesh)
            grads = torch.autograd.grad(loss, leaves)
        out[str(remat)] = {"loss": loss, "calls": len(calls), "grads": list(grads)}
    return out


@case
def grpo_step_fsdp2_tp2(inputs):
    """Two sharded GRPO steps from the JAX init: metrics of each, then every
    parameter."""
    from ray_tpu_torch.models.llama import params_from_jax
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.rl.grpo import GRPOConfig, make_grpo_step
    from ray_tpu_torch.train.step import AdamW, TrainState, shard_train_state

    mesh = make_mesh(MeshConfig(fsdp=2, tp=2), device_type=DEVICE)
    opt = AdamW(**inputs["grpo_opt_kw"])
    params = params_from_jax(inputs["grpo_params"], DEVICE)
    state = shard_train_state(TrainState(step=0, params=params, opt_state=opt.init(params)), mesh)
    step = make_grpo_step(_llama_cfg(), opt, GRPOConfig(**inputs["grpo_kw"]), mesh=mesh)
    batch = {k: _t(v) for k, v in inputs["grpo_batch"].items()}
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append(m)
    return {"metrics": metrics, "params": state.params}


@case
def llama_heads_indivisible(inputs):
    """tp4 with tiny's 2 kv heads: the attention cannot keep whole GQA
    groups on each rank, so it raises (never the plain path)."""
    import torch

    from ray_tpu_torch.models.llama import llama_loss
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    mesh = make_mesh(MeshConfig(tp=4), device_type=DEVICE)
    _, state = _sharded_state(inputs, mesh)
    tokens, targets = (_t(a).long() for a in inputs["llama_batch"])
    try:
        llama_loss(state.params, tokens, targets, _llama_cfg(), mesh=mesh)
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


@case
def batch_shards(inputs):
    """Rows placed by batch_sharding_spec on dp2 x fsdp2: this rank's rows;
    and a row count that does not divide by dp x fsdp is refused."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, batch_sharding_spec, make_mesh
    from ray_tpu_torch.parallel.sharding import shard_tensor, spec_placements

    mesh = make_mesh(MeshConfig(dp=2, fsdp=2), device_type=DEVICE)
    pl = spec_placements(mesh, batch_sharding_spec())
    rows = _t(inputs["batch_rows"])
    local = shard_tensor(rows, mesh, pl).to_local()
    try:
        shard_tensor(rows[:6], mesh, pl)
    except ValueError as e:
        return {"local": local, "raised": str(e)}
    return {"local": local, "raised": None}


@case
def llama_factory_fsdp2_tp2(inputs):
    """make_train_state_factory(mesh=...) from seed 0 against the unsharded
    factory from seed 0: the largest difference of any parameter or moment."""
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.train.step import _leaves, default_optimizer, make_train_state_factory

    mesh = make_mesh(MeshConfig(fsdp=2, tp=2), device_type=DEVICE)
    cfg, opt = _llama_cfg(), default_optimizer()
    sharded = make_train_state_factory(cfg, opt, mesh=mesh)(seed=0)
    plain = make_train_state_factory(cfg, opt)(seed=0, device=DEVICE)
    trees = [(sharded.params, plain.params), (sharded.opt_state.mu, plain.opt_state.mu),
             (sharded.opt_state.nu, plain.opt_state.nu)]
    diff = max(float((a.full_tensor() - b).abs().max()) for s, p in trees
               for a, b in zip(_leaves(s), _leaves(p)))
    return {"max_diff": diff, "n_leaves": len(_leaves(sharded.params)),
            "count": sharded.opt_state.count, "step": sharded.step}


@case
def ppo_loss_fsdp2_tp2(inputs):
    """The PPO loss, its metrics and every gradient (policy and the plain
    value head) at fsdp2 x tp2, and value_estimates."""
    import torch

    from ray_tpu_torch.models.llama import llama_logical_axes, params_from_jax
    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, shard_pytree
    from ray_tpu_torch.rl.ppo import PPOConfig, ppo_loss, value_estimates, value_head_from_jax
    from ray_tpu_torch.train.step import _leaves

    mesh = make_mesh(MeshConfig(fsdp=2, tp=2), device_type=DEVICE)
    cfg = _llama_cfg()
    params = shard_pytree(params_from_jax(inputs["ppo_params"], DEVICE), llama_logical_axes(cfg), mesh,
                          DEFAULT_LLM_RULES)
    vh = value_head_from_jax(inputs["ppo_value_head"], DEVICE)
    leaves = _leaves(params) + _leaves(vh)
    for p in leaves:
        p.requires_grad_(True)
    batch = {k: _t(v) for k, v in inputs["ppo_batch"].items()}
    loss, aux = ppo_loss(params, vh, batch, cfg, PPOConfig(**inputs["ppo_kw"]), mesh=mesh)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        values = value_estimates(params, vh, batch["tokens"], cfg, mesh=mesh)
    return {"loss": loss, "aux": aux, "grads": list(grads), "values": values}
