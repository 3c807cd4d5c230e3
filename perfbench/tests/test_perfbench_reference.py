"""The plain reference on hand-computed tiny cases."""

import math

import numpy as np
import pytest
import torch

from perfbench.reference import llama as ref

D = ref.Dims(vocab=3, hidden=4, inter=2, layers=1, heads=2, kv_heads=1, head_dim=2,
             rope_theta=10000.0, eps=0.0)


def _params():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return {"embed_tokens": r(3, 4), "final_norm": torch.ones(4), "lm_head": r(4, 3),
            "layers": {"attn_norm": torch.ones(1, 4), "mlp_norm": torch.ones(1, 4),
                       "wq": r(1, 4, 4), "wk": r(1, 4, 2), "wv": r(1, 4, 2), "wo": r(1, 4, 4),
                       "w_gate": r(1, 4, 2), "w_up": r(1, 4, 2), "w_down": r(1, 2, 4)}}


def _np(t):
    return t.double().numpy()


def test_one_token_forward_by_hand():
    """At position 0 rope is the identity and attention returns v."""
    p = _params()
    x = _np(p["embed_tokens"][1])
    L = {k: _np(v[0]) for k, v in p["layers"].items()}
    y = x / np.sqrt((x ** 2).mean())
    v = y @ L["wv"]
    o = np.concatenate([v, v])  # two q heads share the one kv head
    x = x + o @ L["wo"]
    y = x / np.sqrt((x ** 2).mean())
    g = y @ L["w_gate"]
    x = x + ((g / (1 + np.exp(-g))) * (y @ L["w_up"])) @ L["w_down"]
    y = x / np.sqrt((x ** 2).mean())
    want = y @ _np(p["lm_head"])
    got = ref.logits(D, p, torch.tensor([1]))[0]
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5, atol=1e-5)


def test_rope_rotates_the_halves():
    cos, sin = ref.rope_tables(D, torch.tensor([0, 1]), "cpu")
    x = torch.tensor([[[1.0, 0.0]], [[1.0, 0.0]]])  # [S=2, heads=1, D=2]
    out = ref.rope(x, cos, sin)
    assert torch.allclose(out[0, 0], torch.tensor([1.0, 0.0]))
    assert torch.allclose(out[1, 0], torch.tensor([math.cos(1.0), math.sin(1.0)]))


def test_causal_attention_by_hand():
    q = torch.tensor([[[1.0, 0.0]], [[0.0, 1.0]]])
    k = torch.tensor([[[1.0, 0.0]], [[0.0, 2.0]]])
    v = torch.tensor([[[1.0, 2.0]], [[3.0, 4.0]]])
    out = ref.attention(q, k, v, ref.exact, q_block=1)
    assert torch.allclose(out[0, 0], v[0, 0])  # the first row sees itself only
    s = torch.tensor([0.0, 2.0]) / math.sqrt(2)
    w = torch.softmax(s, 0)
    assert torch.allclose(out[1, 0], w[0] * v[0, 0] + w[1] * v[1, 0])


def test_fp8_round_is_coarser_than_bf16():
    t = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    e8 = ((ref.fp8_round(t) - t).abs() / t.abs().clamp(min=1e-3)).median()
    e16 = ((t.bfloat16().float() - t).abs() / t.abs().clamp(min=1e-3)).median()
    assert e8 > 8 * e16 and e8 < 2 ** -4


def test_schedule_and_first_update():
    opt = ref.AdamW(warmup_steps=10, total_steps=1000)
    assert opt.rate(0) == 0.0 and opt.rate(1) == pytest.approx(3e-5)
    assert opt.rate(10) == pytest.approx(3e-4) and opt.rate(1000) == pytest.approx(3e-5)


def test_train_steps_first_update_is_at_rate_zero():
    p = _params()
    tokens = torch.tensor([[0, 1, 2, 1]])
    out = ref.train_steps(D, p, [(tokens, torch.roll(tokens, -1, 1))],
                          ref.AdamW(warmup_steps=10, total_steps=100))
    assert all(v == 0.0 for v in out["change"].values())
    lv = ref.loss(D, {k: ({n: w.float() for n, w in v.items()} if isinstance(v, dict) else
                          v.float()) for k, v in p.items()},
                  tokens, torch.roll(tokens, -1, 1), ref.exact)
    assert out["losses"][0] == pytest.approx(float(lv))
