"""The torch -> JAX direction of the parameter converter
(``ray_tpu_torch.models.llama.params_to_jax``), the inverse of
``params_from_jax``, held against the JAX package on the CPU.

- The round trip ``params_from_jax(params_to_jax(p))`` gives ``p`` bit for
  bit, in bf16 and fp32, and the numpy leaves load into JAX arrays of the
  same dtype and bits.
- A port ``TrainState`` after 3 steps, carried into a JAX ``TrainState``
  (built here from ``default_optimizer().init`` with the port's step, count
  and AdamW moments), continues 3 JAX steps that match 3 more port steps,
  at ``tests/test_torch_train.py``'s tolerances.
- The JAX ``llama_loss`` on the converted parameters equals the port's.
"""

import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.train import step as js
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import step as ts

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32, remat=None, attention_impl="reference")
OPT_KW = dict(lr=1e-2, warmup_steps=1, total_steps=50)


def _tcfg(dtype=torch.float32):
    return tl.LlamaConfig.tiny(dtype=dtype, remat=None)


def _tokens(seed, shape=(4, 64)):
    tokens = np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _flat(tree):
    """Leaves in key-sorted order (the port's _leaves order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    return [tree]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_round_trip_is_bit_exact(dtype):
    params = tl.llama_init(_tcfg(dtype), seed=3, device="cpu")
    numpy_tree = tl.params_to_jax(params)
    want_np = ml_dtypes.bfloat16 if dtype == torch.bfloat16 else np.float32
    assert all(isinstance(a, np.ndarray) and a.dtype == want_np for a in _flat(numpy_tree))
    # the stacked [L, ...] x @ W layout, as the JAX package's llama_init draws it
    jshapes = jax.eval_shape(lambda k: jl.llama_init(JCFG, k), jax.random.key(0))
    assert jax.tree.map(lambda a: a.shape, numpy_tree) == jax.tree.map(lambda a: a.shape, jshapes)
    back = tl.params_from_jax(numpy_tree)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for got, want in zip(_flat(back), _flat(params)):
        assert got.dtype == want.dtype and torch.equal(got.view(bits), want.view(bits))
    # the leaves load into JAX arrays of the same type and bits
    jtree = jax.tree.map(jnp.asarray, numpy_tree)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for got, want in zip(_flat(jtree), _flat(params)):
        assert got.dtype == jdt
        np.testing.assert_array_equal(np.asarray(got).view(np.int16 if bits == torch.int16
                                                           else np.int32),
                                      want.view(bits).numpy())


def test_bf16_without_ml_dtypes_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    params = tl.llama_init(_tcfg(torch.bfloat16), seed=0, device="cpu")
    with pytest.raises(ImportError, match="ml_dtypes"):
        tl.params_to_jax(params)
    # fp32 leaves need no bf16 type
    assert tl.params_to_jax({"w": torch.ones(2)})["w"].dtype == np.float32


def _jax_train_state(state: ts.TrainState, jopt) -> js.TrainState:
    """A JAX TrainState with the port state's step, parameters, AdamW count
    and moments, and schedule count (the optax state from jopt.init)."""
    jparams = jax.tree.map(jnp.asarray, tl.params_to_jax(state.params))
    mu = jax.tree.map(jnp.asarray, tl.params_to_jax(state.opt_state.mu))
    nu = jax.tree.map(jnp.asarray, tl.params_to_jax(state.opt_state.nu))
    count = jnp.asarray(state.opt_state.count, jnp.int32)

    def carry(s):
        if hasattr(s, "_fields"):
            if "mu" in s._fields and "nu" in s._fields:
                return s._replace(count=count, mu=mu, nu=nu)
            if "count" in s._fields:
                return s._replace(count=count)
            return s
        if isinstance(s, tuple):
            return type(s)(carry(x) for x in s)
        return s

    return js.TrainState(step=jnp.asarray(state.step, jnp.int32), params=jparams,
                         opt_state=carry(jopt.init(jparams)))


def test_train_state_carried_back_continues_in_jax():
    tokens, targets = _tokens(1)
    cfg = _tcfg()
    topt = ts.default_optimizer(**OPT_KW)
    state = ts.make_train_state_factory(cfg, topt)(seed=0, device="cpu")
    tstep = ts.make_train_step(cfg, topt)
    tt, tg = torch.from_numpy(tokens).long(), torch.from_numpy(targets).long()
    for _ in range(3):
        state, _ = tstep(state, tt, tg)
    jopt = js.default_optimizer(**OPT_KW)
    jstate = _jax_train_state(state, jopt)
    # the moments and parameters carried exactly
    for got, want in zip(_flat(jstate.params), _flat(state.params)):
        np.testing.assert_array_equal(np.asarray(got), want.detach().numpy())
    jstep = js.make_train_step(JCFG, jopt, donate=False)
    with jax.default_matmul_precision("highest"):
        for _ in range(3):
            jstate, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
            state, m = tstep(state, tt, tg)
            assert abs(m["loss"].item() - float(jm["loss"])) < 1e-4
            np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
    assert int(jstate.step) == state.step == 6 and state.opt_state.count == 6
    # Parameters (as in test_torch_train.py): elements whose gradient lies
    # within fp32 rounding of 0 may move by up to one update (lr); every
    # other element within 1e-4.
    diffs = [np.abs(got.detach().numpy() - np.asarray(want)) - 1e-4 * np.abs(np.asarray(want))
             for got, want in zip(_flat(state.params), _flat(jstate.params))]
    n_far = sum(int((d > 1e-4).sum()) for d in diffs)
    n_all = sum(d.size for d in diffs)
    assert n_far <= 1e-4 * n_all, (n_far, n_all)
    assert max(float(d.max()) for d in diffs) <= OPT_KW["lr"]


def test_jax_loss_on_converted_params_equals_the_ports():
    cfg = _tcfg()
    params = tl.llama_init(cfg, seed=5, device="cpu")
    tokens, targets = _tokens(2, (2, 64))
    got = tl.llama_loss(params, torch.from_numpy(tokens).long(),
                        torch.from_numpy(targets).long(), cfg).item()
    jparams = jax.tree.map(jnp.asarray, tl.params_to_jax(params))
    with jax.default_matmul_precision("highest"):
        want = float(jl.llama_loss(jparams, jnp.asarray(tokens), jnp.asarray(targets), JCFG))
    assert abs(got - want) < 1e-5
