"""Port parity, ops and model: ray_tpu_torch against ray_tpu on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
PyTorch counterpart, in fp32, at the JAX package's own tolerances. JAX's
flash kernel runs in Pallas interpret mode; the port's flash wrapper takes
its plain version for CPU tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops.attention import flash_attention as j_flash_attention
from ray_tpu.ops.attention import reference_attention as j_reference_attention
from ray_tpu.ops.norms import rms_norm as j_rms_norm
from ray_tpu.ops.rope import apply_rope as j_apply_rope
from ray_tpu.ops.rope import rope_frequencies as j_rope_frequencies
from ray_tpu_torch.models import llama as tl
import ray_tpu_torch.ops.attention as ta
from ray_tpu_torch.ops.norms import rms_norm as t_rms_norm
from ray_tpu_torch.ops.rope import apply_rope as t_apply_rope
from ray_tpu_torch.ops.rope import rope_frequencies as t_rope_frequencies


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def test_rope_frequencies_match():
    jc, js = j_rope_frequencies(64, 300, 500000.0)
    tc, ts = t_rope_frequencies(64, 300, 500000.0, device="cpu")
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("positions", [
    None,
    [[3, 4, 5, 6]],
    [[126, 127, 128, 400]],  # past the 128-row table: JAX clamps the gather
    [[-3, 0, 1, -200]],      # negative: JAX counts from the end, then clamps
])
def test_apply_rope_matches_jax(positions):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 4, 3, 32)).astype(np.float32)
    jc, js = j_rope_frequencies(32, 128)
    tc, ts = t_rope_frequencies(32, 128, device="cpu")
    jp = None if positions is None else jnp.asarray(positions, jnp.int32)
    tp = None if positions is None else torch.tensor(positions, dtype=torch.int32)
    want = np.asarray(j_apply_rope(jnp.asarray(x), jc, js, positions=jp))
    got = t_apply_rope(_t(x), tc, ts, positions=tp).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_apply_rope_keeps_dtype_bf16():
    x = torch.randn(1, 4, 2, 32).to(torch.bfloat16)
    c, s = t_rope_frequencies(32, 16, device="cpu")
    assert t_apply_rope(x, c, s).dtype == torch.bfloat16


# --------------------------------------------------------------------------- #
# RMSNorm
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rms_norm_matches_jax(eps):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 32)).astype(np.float32)
    w = rng.standard_normal((32,)).astype(np.float32)
    want = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w), eps))
    got = t_rms_norm(_t(x), _t(w), eps).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #
ATTN_CASES = [
    # (b, sq, skv, hq, hkv, d, causal)
    (2, 64, 64, 4, 2, 32, True),     # GQA causal
    (1, 64, 64, 4, 4, 32, False),    # MHA non-causal
    (2, 48, 112, 4, 2, 32, True),    # Sq < Skv, bottom-right causal
    (1, 50, 50, 2, 1, 64, True),     # ragged (not a block multiple)
    (1, 37, 91, 4, 2, 32, False),    # ragged non-causal, Sq < Skv
]


def _attn_inputs(b, sq, skv, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", ATTN_CASES)
def test_attention_matches_jax_reference_and_interpret_kernel(b, sq, skv, hq, hkv, d, causal):
    q, k, v = _attn_inputs(b, sq, skv, hq, hkv, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    with jax.default_matmul_precision("highest"):
        want_ref = np.asarray(j_reference_attention(jq, jk, jv, causal=causal))
        want_flash = np.asarray(j_flash_attention(jq, jk, jv, causal=causal, interpret=True,
                                                   block_q=32, block_k=32))
    tq, tk, tv = map(_t, (q, k, v))
    for got in (ta.reference_attention(tq, tk, tv, causal=causal),
                ta.flash_attention(tq, tk, tv, causal=causal),
                ta.attention(tq, tk, tv, causal=causal, impl="auto"),
                ta.attention(tq, tk, tv, causal=causal, impl="reference")):
        np.testing.assert_allclose(got.numpy(), want_ref, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(got.numpy(), want_flash, atol=2e-5, rtol=2e-5)


def test_attention_rejects_what_jax_rejects():
    q, k, v = map(_t, _attn_inputs(1, 32, 16, 4, 2, 32))
    with pytest.raises(ValueError, match="Skv >= Sq"):
        ta.flash_attention(q, k, v, causal=True)
    q3, k3, v3 = map(_t, _attn_inputs(1, 16, 16, 4, 3, 32))
    with pytest.raises(ValueError, match="multiple"):
        ta.flash_attention(q3, k3, v3)
    with pytest.raises(ValueError, match="unknown attention impl"):
        ta.attention(q, q, q, impl="flash_interpret")


# --------------------------------------------------------------------------- #
# Parameters and the model
# --------------------------------------------------------------------------- #
def test_params_from_jax_copies_bf16_bits_exactly():
    cfg = jl.LlamaConfig.tiny()  # bf16 weights
    jp = jl.llama_init(cfg, jax.random.key(3))
    tp = tl.params_from_jax(jp)
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    for name in ("embed_tokens", "lm_head", "final_norm"):
        want = np.asarray(jp[name]).view(np.uint16)
        assert np.array_equal(tp[name].view(torch.int16).numpy().view(np.uint16), want)
    want = np.asarray(jp["layers"]["w_down"]).view(np.uint16)
    got = tp["layers"]["w_down"].view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(got, want)


def test_params_from_jax_fp32_and_layout():
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    jp = jl.llama_init(cfg, jax.random.key(4))
    tp = tl.params_from_jax(jp)
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for name, w in jp["layers"].items():
        assert tuple(tp["layers"][name].shape) == w.shape
        assert tp["layers"][name].dtype == torch.float32
        np.testing.assert_array_equal(tp["layers"][name].numpy(), np.asarray(w))


def test_config_presets_match_jax():
    for preset in ("tiny", "llama_1b", "llama3_8b"):
        j = getattr(jl.LlamaConfig, preset)()
        t = getattr(tl.LlamaConfig, preset)()
        for f in ("vocab_size", "hidden_size", "intermediate_size", "num_layers", "num_heads",
                  "num_kv_heads", "max_seq_len", "rope_theta", "rms_eps", "tie_embeddings"):
            assert getattr(t, f) == getattr(j, f), (preset, f)
        assert t.num_params == j.num_params and t.head_dim_ == j.head_dim_
        assert t.dtype == torch.bfloat16


def test_llama_init_is_seeded():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    a = tl.llama_init(cfg, seed=5, device="cpu")
    b = tl.llama_init(cfg, seed=5, device="cpu")
    c = tl.llama_init(cfg, seed=6, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert a["layers"]["wq"].shape == (2, 128, 128)


@pytest.mark.parametrize("tie", [False, True])
def test_llama_forward_matches_jax(tie):
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, remat=None, attention_impl="reference",
                               tie_embeddings=tie)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, tie_embeddings=tie)
    jp = jl.llama_init(jcfg, jax.random.key(0))
    tokens = np.random.default_rng(2).integers(0, 256, (2, 24)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jl.llama_forward(jp, jnp.asarray(tokens), jcfg))
    got = tl.llama_forward(tl.params_from_jax(jp), _t(tokens).long(), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.llama_init(cfg)
