"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without an NVIDIA card. On a machine with
one (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance, bf16 kernel output against the plain version on the same bf16
inputs: |kernel - plain| <= 1e-2 + 1.6e-2 |plain| (PyTorch's bf16 rtol;
the atol covers outputs near 0, where the kernel's bf16 probabilities in
P.V leave absolute error)."""

import pytest
import torch

from ray_tpu_torch import _kernels
from ray_tpu_torch.models import paged_decode as pd
from ray_tpu_torch.ops.attention import flash_attention, reference_attention

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1.6e-2, 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(out, ref):
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs()
    assert (err <= ATOL + RTOL * ref.float().abs()).all(), err.max().item()


def _bf16(shape, g, dev):
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", [
    (2, 128, 128, 4, 2, 128, True),
    (1, 64, 64, 16, 4, 128, True),
    (2, 77, 77, 4, 1, 64, True),      # ragged
    (1, 33, 190, 8, 2, 128, True),    # Sq < Skv, bottom-right causal
    (1, 1, 65, 4, 4, 64, True),       # one query row
    (2, 100, 70, 4, 2, 64, False),    # non-causal, Sq > Skv
    (1, 256, 256, 8, 8, 128, False),
])
def test_flash_fwd_matches_plain(dev, b, sq, skv, hq, hkv, d, causal):
    g = torch.Generator(device=dev).manual_seed(b * 1000 + sq + skv)
    q, k, v = _bf16((b, sq, hq, d), g, dev), _bf16((b, skv, hkv, d), g, dev), \
        _bf16((b, skv, hkv, d), g, dev)
    before = _kernels.launch_counts["flash_fwd"]
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    out = flash_attention(q, k, v, causal=causal, lse=lse)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["flash_fwd"] == before + 1
    _close(out, reference_attention(q, k, v, causal=causal))
    # lse against the plain log-sum-exp of the masked, scaled logits
    kr = k.float().repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * d ** -0.5
    if causal:
        mask = (torch.arange(sq, device=dev)[:, None] + skv - sq) >= torch.arange(skv, device=dev)
        logits = logits.masked_fill(~mask, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), atol=1e-3, rtol=1e-4)


def test_flash_fwd_rejects_what_it_does_not_take(dev):
    q = torch.randn(1, 8, 2, 128, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q, q, q)
    q32 = torch.randn(1, 8, 2, 32, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q32, q32, q32)
    qt = torch.randn(1, 2, 8, 128, device=dev).to(torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(qt, qt, qt)


@pytest.mark.parametrize("b,nh,nkv,d,ps,max_pages", [
    (8, 16, 4, 128, 64, 8),
    (5, 32, 8, 128, 16, 6),     # llama3_8b's heads
    (3, 4, 1, 128, 32, 4),
    (64, 16, 4, 128, 64, 32),   # the serving engine's table width at llama_1b
])
def test_paged_attention_matches_plain(dev, b, nh, nkv, d, ps, max_pages):
    g = torch.Generator().manual_seed(b + nh + d)
    total = 1 + b * max_pages
    lengths = torch.randint(1, max_pages * ps + 1, (b,), generator=g, dtype=torch.int32)
    lengths[0] = 1  # an inactive slot reading the trash page
    perm = torch.randperm(total - 1, generator=g) + 1
    table = torch.zeros((b, max_pages), dtype=torch.int32)
    for s in range(1, b):
        n = -(-int(lengths[s]) // ps)
        table[s, :n] = perm[s * max_pages: s * max_pages + n]
    gd = torch.Generator(device=dev).manual_seed(7)
    kp, vp = _bf16((nkv, total, ps, d), gd, dev), _bf16((nkv, total, ps, d), gd, dev)
    q = (torch.randn((b, nh, d), generator=gd, device=dev) * d ** -0.5).to(torch.bfloat16)
    table, lengths = table.to(dev), lengths.to(dev)
    before = _kernels.launch_counts["paged_attention"]
    out = pd.paged_attention(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["paged_attention"] == before + 1
    _close(out, pd._paged_attention_reference(q, kp, vp, table, lengths, 1.0))


def test_paged_attention_rejects_what_it_does_not_take(dev):
    q = torch.randn(2, 8, 128, device=dev)
    pool = torch.zeros(2, 3, 16, 128, device=dev)
    table = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        pd.paged_attention(q, pool, pool, table, lengths)
    qb, pb = q.to(torch.bfloat16), pool.to(torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        pd.paged_attention(qb, pb, pb, table.long(), lengths)
    with pytest.raises(ValueError, match="nh/n_kv"):
        q6 = torch.zeros(2, 6, 128, device=dev, dtype=torch.bfloat16)
        pd.paged_attention(q6, pb[:1], pb[:1], table, lengths)
    with pytest.raises(ValueError, match="D 128"):
        q64 = torch.zeros(2, 8, 64, device=dev, dtype=torch.bfloat16)
        p64 = torch.zeros(2, 3, 16, 64, device=dev, dtype=torch.bfloat16)
        pd.paged_attention(q64, p64, p64, table, lengths)
