"""The fp32 flash kernels' 3xTF32 numerics on the CPU, before the card.

``csrc/flash_fwd_f32.cu`` computes the forward (K1, K1') and
``csrc/flash_bwd_f32.cu`` dQ (K2) and dK/dV (K3) in fp32 on the tensor
cores in 3xTF32: each operand x is split as hi = tf32(x) and
lo = tf32(x - hi), tf32 being ``cvt.rna`` (round to nearest, ties away from
zero, to 10 mantissa bits), and each product is lo.hi + hi.lo + hi.hi,
accumulated in fp32. Here those products are emulated in torch and run
through the port's plain forward and plain dQ and dK/dV (``einsum=``); the
result is held against the JAX package's Pallas forward and backward in
interpret mode, as tests/test_ops_attention.py holds fp32 flash:
atol = rtol = 2e-5. The backward takes JAX's residuals (out and lse), so
only the backward differs there. Plain TF32 (hi.hi alone) misses that
tolerance, which the last two tests show.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch.ops.attention as ta

# the module (ray_tpu.ops re-exports a function of the same name)
j_attn = importlib.import_module("ray_tpu.ops.attention")

TOL = 2e-5  # tests/test_ops_attention.py's fp32 flash tolerance


def _tf32(x):
    """cvt.rna.tf32.f32: round the fp32 magnitude to 10 mantissa bits, half
    away from zero (add half of the 13 dropped bits, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def einsum_tf32x3(eq, a, b):
    """The kernels' products: lo.hi + hi.lo + hi.hi in fp32 (lo.lo dropped)."""
    (ah, al), (bh, bl) = _split(a.float()), _split(b.float())
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def einsum_tf32(eq, a, b):
    """One TF32 product: hi.hi."""
    return torch.einsum(eq, _tf32(a.float()), _tf32(b.float()))


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # tf32's spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 3 * ulp / 2, 3.0e-3, -7.25], dtype=torch.float32)
    got = _tf32(x).tolist()
    assert got[:4] == [one + ulp, -(one + ulp), one, one + 2 * ulp]
    assert got[5] == -7.25  # exact in 10 bits
    assert abs(got[4] - 3.0e-3) <= 3.0e-3 * 2 ** -11
    hi, lo = _split(x)
    assert torch.all((hi + lo - x).abs() <= x.abs() * 2 ** -21)


# (b, sq, skv, hq, hkv, d, causal, block): the Pallas kernels need whole
# blocks; 48 and 80 rows are ragged against the card's 64-row tiles
CASES = [
    (1, 64, 64, 4, 4, 64, True, 32),     # D64, group 1
    (2, 64, 64, 8, 2, 64, False, 32),    # D64, group 4
    (1, 64, 64, 8, 1, 64, True, 32),     # D64, group 8
    (1, 64, 64, 4, 4, 128, False, 32),   # D128, group 1
    (1, 64, 64, 8, 2, 128, True, 32),    # D128, group 4: the c5 fp32 heads
    (1, 64, 64, 8, 1, 128, False, 32),   # D128, group 8
    (1, 64, 64, 2, 2, 256, True, 32),    # D256, group 1
    (1, 64, 64, 8, 2, 256, False, 32),   # D256, group 4
    (1, 64, 64, 8, 1, 256, True, 32),    # D256, group 8
    (1, 48, 80, 8, 2, 128, True, 16),    # ragged, Sq < Skv, bottom-right causal
    (1, 48, 80, 4, 1, 64, False, 16),    # ragged, Sq < Skv, not causal
    (1, 48, 80, 8, 2, 256, True, 16),    # ragged at D256
]


def _inputs(b, sq, skv, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    return q, k, v, g


def _jax_backward(q, k, v, g, causal, block):
    """JAX's flash forward and backward (Pallas, interpret mode): out, lse
    [B, Hq, Sq] and (dq, dk, dv)."""
    scale = q.shape[-1] ** -0.5
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    with jax.default_matmul_precision("highest"):
        out, lse = j_attn._flash_fwd(jq, jk, jv, causal, scale, block, block, True,
                                     with_lse=True)
        grads = j_attn._flash_bwd(jq, jk, jv, out, lse, jg, causal, scale, block, block, True)
    return np.asarray(out), np.asarray(lse)[..., 0], [np.asarray(a) for a in grads]


def _port_backward(q, k, v, g, out, lse, causal, einsum):
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, g, out, lse)]
    q_, k_, v_, g_, out_, lse_ = t
    scale = q.shape[-1] ** -0.5
    delta = ta._delta(out_, g_)
    dq = ta.flash_bwd_dq_reference(q_, k_, v_, g_, lse_, delta, causal, scale, einsum=einsum)
    dk, dv = ta.flash_bwd_dkv_reference(q_, k_, v_, g_, lse_, delta, causal, scale,
                                        einsum=einsum)
    return dq, dk, dv


def _port_forward(q, k, v, causal, einsum):
    """The port's plain forward with ``einsum``'s products: (out, lse) from
    reference_attention_lse, and reference_attention's out."""
    q_, k_, v_ = (torch.from_numpy(np.array(a)) for a in (q, k, v))
    out, lse, out_lo = ta.reference_attention_lse(q_, k_, v_, causal, einsum=einsum)
    assert not out_lo.any()  # fp32: no rounding residual
    return out, lse, ta.reference_attention(q_, k_, v_, causal, einsum=einsum)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,block", CASES)
def test_tf32x3_forward_matches_jax_interpret(b, sq, skv, hq, hkv, d, causal, block):
    """K1 and K1' in 3xTF32 (flash_fwd_f32.cu's products) against the Pallas
    forward in interpret mode: out and lse within 2e-5."""
    q, k, v, g = _inputs(b, sq, skv, hq, hkv, d, seed=sq + skv + hq + d)
    out, lse, _ = _jax_backward(q, k, v, g, causal, block)
    got_out, got_lse, got_k1 = _port_forward(q, k, v, causal, einsum_tf32x3)
    for name, a, w in (("out", got_out, out), ("lse", got_lse, lse), ("K1 out", got_k1, out)):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, atol=TOL, rtol=TOL, err_msg=name)


def test_plain_tf32_forward_misses_the_tolerance():
    """The reason for three products in the forward too: one TF32 product
    per pair misses 2e-5 on the c5 fp32 heads."""
    b, sq, skv, hq, hkv, d, causal, block = CASES[4]
    q, k, v, g = _inputs(b, sq, skv, hq, hkv, d, seed=sq + skv + hq + d)
    out, lse, _ = _jax_backward(q, k, v, g, causal, block)
    got_out, got_lse, _ = _port_forward(q, k, v, causal, einsum_tf32)
    worst = max(float((np.abs(a.numpy() - w) / (TOL + TOL * np.abs(w))).max())
                for a, w in ((got_out, out), (got_lse, lse)))
    assert worst > 1.0


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,block", CASES)
def test_tf32x3_backward_matches_jax_interpret(b, sq, skv, hq, hkv, d, causal, block):
    q, k, v, g = _inputs(b, sq, skv, hq, hkv, d, seed=sq + skv + hq + d)
    out, lse, want = _jax_backward(q, k, v, g, causal, block)
    got = _port_backward(q, k, v, g, out, lse, causal, einsum_tf32x3)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, atol=TOL, rtol=TOL, err_msg=name)


def test_plain_tf32_misses_the_tolerance():
    """The reason for three products in the backward: one TF32 product per
    pair misses 2e-5 on the c5 fp32 heads."""
    b, sq, skv, hq, hkv, d, causal, block = CASES[4]
    q, k, v, g = _inputs(b, sq, skv, hq, hkv, d, seed=sq + skv + hq + d)
    out, lse, want = _jax_backward(q, k, v, g, causal, block)
    got = _port_backward(q, k, v, g, out, lse, causal, einsum_tf32)
    worst = max(float((np.abs(a.numpy() - w) / (TOL + TOL * np.abs(w))).max())
                for a, w in zip(got, want))
    assert worst > 1.0
