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
from ray_tpu_torch import _kernels
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
    # head dim 256: the bf16 forward kernel's widest instance on the card
    (1, 64, 64, 8, 2, 256, True),    # group 4, causal
    (1, 50, 50, 8, 1, 256, True),    # group 8, ragged
    (1, 37, 91, 4, 4, 256, False),   # group 1, ragged non-causal, Sq < Skv
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


@pytest.mark.parametrize("d,grad,tiles", [
    (128, False, True),   # llama_1b, serving
    (128, True, True),    # llama_1b, training
    (64, False, True),    # ViT's D64: the forward kernel
    (64, True, True),     # ... and the backward kernels
    (32, False, False),   # tiny: D32
    (32, True, False),
    (256, False, True),   # D256: the tensor-core forward (wgmma in bf16, 3xTF32 in fp32)
    (256, True, True),    # ... and the tensor-core backward
    (384, False, False),
])
def test_flash_dispatch_rule(d, grad, tiles):
    """Only the head dim decides: a dtype or layout the kernels do not take
    at a head dim they tile goes to the wrappers, which raise."""
    assert ta.flash_tiles(d, grad) is tiles


@pytest.mark.parametrize("kernel,dtype,d,route", [
    ("flash_fwd", torch.bfloat16, 256, "wgmma"),     # the tensor-core forward at D256
    ("flash_bwd_dq", torch.bfloat16, 256, "wgmma"),  # the D256 backward on the tensor cores
    ("flash_bwd_dkv", torch.bfloat16, 256, "wgmma"),
    ("flash_fwd", torch.bfloat16, 64, "wgmma"),
    ("flash_fwd", torch.bfloat16, 128, "wgmma"),
    ("flash_bwd_dq", torch.bfloat16, 64, "wgmma"),
    ("flash_bwd_dkv", torch.bfloat16, 128, "wgmma"),
    ("flash_fwd", torch.float32, 64, "tf32x3"),      # the fp32 forward: 3xTF32 tensor cores
    ("flash_fwd", torch.float32, 128, "tf32x3"),
    ("flash_fwd", torch.float32, 256, "tf32x3"),
    ("flash_bwd_dq", torch.float32, 128, "tf32x3"),  # the fp32 backward: 3xTF32 tensor cores
    ("flash_bwd_dkv", torch.float32, 256, "tf32x3"),
    ("flash_bwd_dq", torch.float32, 64, "tf32x3"),
    ("flash_bwd_dq", torch.float32, 256, "tf32x3"),
    ("flash_bwd_dkv", torch.float32, 64, "tf32x3"),
    ("flash_bwd_dkv", torch.float32, 128, "tf32x3"),
])
def test_simt_route(kernel, dtype, d, route):
    """Which kernel family a CUDA call reaches, by kernel, dtype and head dim
    (no call reaches the CUDA cores any more), and that the family's library
    for the kernel is built from a source in the package."""
    assert ta.kernel_route(kernel, dtype, d) == route
    assert (_kernels.CSRC / f"{ta.ROUTE_LIBS[route][kernel]}.cu").is_file()


@pytest.mark.parametrize("b,skv,hkv,group,sms,splits", [
    (2, 512, 4, 4, 132, 4),     # the c5 fp32 train step: 64 blocks, so one a q head
    (8, 2048, 4, 4, 132, 1),    # llama_1b's training shape: 1024 blocks fill the card
    (1, 128, 2, 8, 132, 8),     # few blocks: every q head on its own
    (2, 512, 4, 6, 132, 6),     # splits divide the group
    (2, 512, 8, 2, 132, 2),
    (4, 1024, 8, 4, 132, 1),
])
def test_dkv_split_count(b, skv, hkv, group, sms, splits):
    """The fp32 dK/dV kernel's blocks along the GQA group: the smallest
    divisor of the group that makes two blocks an SM, else the group."""
    assert ta.dkv_split_count(b, skv, hkv, group, sms) == splits


@pytest.mark.parametrize("kernel,dtype,d,match", [
    ("flash_fwd", torch.bfloat16, 384, "head_dim"),
    ("flash_bwd_dq", torch.float32, 384, "head_dim"),
    ("flash_fwd", torch.float16, 128, "bfloat16 or float32"),
    ("flash_bwd_dkv", torch.float16, 256, "bfloat16 or float32"),
])
def test_simt_route_raises_on_what_no_kernel_takes(kernel, dtype, d, match):
    with pytest.raises(ValueError, match=match):
        ta.kernel_route(kernel, dtype, d)


@pytest.mark.parametrize("grad", [False, True])
def test_attention_auto_on_the_cpu_runs_the_plain_wrappers(grad):
    """CPU tensors go through the wrappers, which run their plain versions:
    the dispatch rule counts nothing there."""
    from ray_tpu_torch import _kernels

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in ((1, 9, 4, 32), (1, 9, 2, 32), (1, 9, 2, 32)))
    if grad:
        q.requires_grad_(True)
    before = dict(_kernels.launch_counts)
    out = ta.attention(q, k, v, causal=True)
    assert dict(_kernels.launch_counts) == before
    torch.testing.assert_close(out, ta.reference_attention(q, k, v, causal=True))
    if grad:
        assert out.grad_fn is not None


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


# --------------------------------------------------------------------------- #
# Training ops: RMSNorm backward, fused cross-entropy, flash lse and backward
# --------------------------------------------------------------------------- #
import importlib  # noqa: E402

from ray_tpu.ops.loss import fused_cross_entropy as j_fused_ce  # noqa: E402
from ray_tpu_torch.ops.loss import fused_cross_entropy as t_fused_ce  # noqa: E402

# ray_tpu.ops re-exports the function `attention`, which shadows the module
j_attn = importlib.import_module("ray_tpu.ops.attention")


def _leaf(a):
    return _t(a).clone().requires_grad_(True)


@pytest.mark.parametrize("shape,eps", [((4, 16, 32), 1e-6), ((2, 3, 5, 64), 1e-5)])
def test_rms_norm_grads_match_jax(shape, eps):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1:]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)  # the output's cotangent
    jg = jax.grad(lambda x, w: (j_rms_norm(x, w, eps) * g).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _leaf(x), _leaf(w)
    (t_rms_norm(tx, tw, eps) * _t(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg[1]), atol=1e-5)


@pytest.mark.parametrize("s,n_chunks,with_mask", [
    (16, 4, False), (16, 4, True),
    (15, 4, False), (15, 4, True),   # ragged: 15 % 4 != 0, largest divisor 3
])
def test_fused_cross_entropy_matches_jax(s, n_chunks, with_mask):
    rng = np.random.default_rng(0)
    b, h, v = 2, 8, 11
    x = rng.standard_normal((b, s, h)).astype(np.float32)
    head = rng.standard_normal((h, v)).astype(np.float32)
    t = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = rng.integers(0, 2, (b, s)).astype(np.float32) if with_mask else None
    jm = None if mask is None else jnp.asarray(mask)
    with jax.default_matmul_precision("highest"):
        jl, jg = jax.value_and_grad(
            lambda x, hd: j_fused_ce(x, hd, jnp.asarray(t), jm, n_chunks), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(head))
    tx, th = _leaf(x), _leaf(head)
    tl = t_fused_ce(tx, th, _t(t), None if mask is None else _t(mask), n_chunks)
    tl.backward()
    assert abs(tl.item() - float(jl)) < 1e-5
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]), atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jg[1]), atol=1e-5)


FLASH_GRAD_CASES = [
    # (b, sq, skv, hq, hkv, d, causal); Pallas interpret mode needs block multiples
    (2, 64, 64, 4, 2, 32, True),     # GQA causal
    (1, 64, 64, 4, 4, 32, False),    # MHA non-causal
    (1, 32, 96, 4, 1, 32, True),     # Sq < Skv, bottom-right causal, 4 q heads per kv head
    (1, 64, 128, 8, 2, 32, False),   # Sq < Skv non-causal
    (1, 64, 64, 8, 2, 256, True),    # D256, group 4, causal: the c5 D256 config's heads
    (1, 64, 128, 4, 1, 256, False),  # D256, group 4, Sq < Skv non-causal
]


def _jax_flash_fwd_bwd(q, k, v, g, causal):
    scale = q.shape[-1] ** -0.5
    with jax.default_matmul_precision("highest"):
        out, lse = j_attn._flash_fwd(*map(jnp.asarray, (q, k, v)), causal, scale, 32, 32,
                                     True, with_lse=True)
        grads = j_attn._flash_bwd(*map(jnp.asarray, (q, k, v)), out, lse, jnp.asarray(g),
                                  causal, scale, 32, 32, True)
    return np.asarray(out), np.asarray(lse)[..., 0], [np.asarray(a) for a in grads]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", FLASH_GRAD_CASES)
def test_flash_lse_and_backward_reference_match_jax_interpret(b, sq, skv, hq, hkv, d, causal):
    q, k, v = _attn_inputs(b, sq, skv, hq, hkv, d, seed=1)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    jout, jlse, jgrads = _jax_flash_fwd_bwd(q, k, v, g, causal)
    out, lse, out_lo = ta.flash_attention_lse(_t(q), _t(k), _t(v), causal)
    assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
    assert not out_lo.any()  # fp32 rounds nothing
    np.testing.assert_allclose(out.numpy(), jout, atol=5e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=5e-5)
    # the plain backward from JAX's own residuals
    grads = ta.flash_bwd_reference(_t(q), _t(k), _t(v), _t(jout), _t(jlse), _t(g), causal)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", FLASH_GRAD_CASES)
def test_flash_op_gradients_match_jax_custom_vjp(b, sq, skv, hq, hkv, d, causal):
    q, k, v = _attn_inputs(b, sq, skv, hq, hkv, d, seed=3)
    g = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jgrads = jax.grad(lambda q, k, v: (j_flash_attention(
            q, k, v, causal=causal, interpret=True, block_q=32, block_k=32) * g).sum(),
            argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    for impl in ("auto", "flash"):
        for t in (tq, tk, tv):
            t.grad = None
        (ta.attention(tq, tk, tv, causal=causal, impl=impl) * _t(g)).sum().backward()
        for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


# ViT's attention (models/vit.py): head dim 64, one q head per kv head, not
# causal. At S64 with blocks of 32 the Pallas kernels run in interpret mode;
# at ViT-L/16's 196 patches JAX's flash_attention takes its reference path
# (Pallas needs whole blocks), so the port is held against
# reference_attention and autograd through it there. The file's 2e-5.
VIT_ATTN_TOL = 2e-5


@pytest.mark.parametrize("b,s,h", [(2, 64, 4), (2, 196, 4)])
def test_vit_attention_forward_lse_and_backward_match_jax(b, s, h):
    q, k, v = _attn_inputs(b, s, s, h, h, 64, seed=5)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    scale = 64 ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    with jax.default_matmul_precision("highest"):
        if s % 32 == 0:
            jout, jlse = j_attn._flash_fwd(jq, jk, jv, False, scale, 32, 32, True, with_lse=True)
            jgrads = j_attn._flash_bwd(jq, jk, jv, jout, jlse, jg, False, scale, 32, 32, True)
            jlse = jlse[..., 0]
        else:
            jout = j_reference_attention(jq, jk, jv, causal=False)
            logits = jnp.einsum("bqhd,bkhd->bhqk", jq, jk) * scale
            jlse = jax.nn.logsumexp(logits, axis=-1)
            jgrads = jax.grad(lambda q, k, v: (j_reference_attention(
                q, k, v, causal=False) * jg).sum(), argnums=(0, 1, 2))(jq, jk, jv)
    out, lse, _ = ta.flash_attention_lse(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=VIT_ATTN_TOL,
                               rtol=VIT_ATTN_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=VIT_ATTN_TOL,
                               rtol=VIT_ATTN_TOL)
    # the plain backward (the kernels' yardstick) and the op with a gradient
    grads = ta.flash_bwd(_t(q), _t(k), _t(v), out, lse, _t(g), causal=False)
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    (ta.attention(tq, tk, tv, causal=False) * _t(g)).sum().backward()
    for got, op_got, want in zip(grads, (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VIT_ATTN_TOL,
                                   rtol=VIT_ATTN_TOL)
        np.testing.assert_allclose(op_got.numpy(), np.asarray(want), atol=VIT_ATTN_TOL,
                                   rtol=VIT_ATTN_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_out_lo_keeps_delta_consistent_in_bf16(seed):
    """bf16 inputs whose keys and values share a large common part, as ViT's
    patches do. out + out_lo is the forward's output before its rounding to
    bf16, and the backward's delta from it matches the softmax's own: dq, dk
    and dv within bf16 rounding of autograd through the plain forward in
    fp32. From the bf16 out alone (the JAX package's delta) dq misses by
    about half its largest element."""
    rng = np.random.default_rng(seed)
    b, s, h, d = 2, 196, 2, 64
    common = rng.standard_normal((1, 1, h, d)) * 2
    arrays = (rng.standard_normal((b, s, h, d)),
              rng.standard_normal((b, s, h, d)) * 0.5 + common,
              rng.standard_normal((b, s, h, d)) * 0.5 + common,
              rng.standard_normal((b, s, h, d)))
    q, k, v, g = (torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) for a in arrays)
    out, lse, out_lo = ta.flash_attention_lse(q, k, v, causal=False)
    assert out_lo.dtype == torch.bfloat16 and out_lo.any()
    out32 = ta.reference_attention(q.float(), k.float(), v.float(), causal=False)
    scale = out32.abs().max()
    assert (out.float() + out_lo.float() - out32).abs().max() <= 2 ** -16 * scale
    assert (out.float() - out32).abs().max() >= 2 ** -10 * scale
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    ta.reference_attention(*leaves, causal=False).backward(g.float())

    def err(got, want):
        return ((got.float() - want).abs().max() / want.abs().max()).item()

    for got, leaf in zip(ta.flash_bwd(q, k, v, out, lse, g, False, out_lo=out_lo), leaves):
        assert err(got, leaf.grad) <= 2 ** -8  # the gradients' own rounding to bf16
    dq_alone = ta.flash_bwd(q, k, v, out, lse, g, False)[0]
    assert err(dq_alone, leaves[0].grad) >= 0.1


def test_flash_backward_rejects_what_jax_rejects():
    q, k, v = map(_t, _attn_inputs(1, 32, 16, 4, 2, 32))
    with pytest.raises(ValueError, match="Skv >= Sq"):
        ta.flash_bwd(q, k, v, q, torch.zeros(1, 4, 32), q, causal=True)
    with pytest.raises(ValueError, match="Skv >= Sq"):
        ta.flash_attention_lse(q, k, v, causal=True)
