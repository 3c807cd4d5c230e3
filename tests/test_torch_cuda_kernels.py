"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips without an NVIDIA card. On a machine with
one (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance, bf16 kernel output against the plain version on the same bf16
inputs: |kernel - plain| <= 1e-2 + 1.6e-2 |plain| (PyTorch's bf16 rtol;
the atol covers outputs near 0, where the kernel's bf16 probabilities in
P.V leave absolute error). The backward kernels' gradients are held to
|kernel - plain| <= 1e-2 max|plain| + 1.6e-2 |plain|: both sides round to
bf16 once, and the kernels' bf16 p and ds in the products leave absolute
error of a few bf16 ulps of the gradient's own scale."""

import pytest
import torch

from ray_tpu_torch import _kernels
from ray_tpu_torch.models import paged_decode as pd
from ray_tpu_torch.ops import attention as ta
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
    # the 128-row q tile and 128-key K/V tile of the kernel
    (1, 129, 129, 8, 2, 128, True),   # one row past a q tile
    (1, 255, 255, 4, 1, 64, True),    # one row short of two tiles
    (1, 255, 255, 8, 2, 128, False),
    (3, 200, 200, 8, 2, 128, True),   # a map that ignored the batch would read the next one
    (3, 200, 200, 4, 2, 64, False),
    (1, 1, 2048, 16, 4, 128, True),   # the diagonal tile alone
    (2, 300, 700, 16, 4, 128, True),  # offset 400: not a tile multiple
])
def test_flash_fwd_matches_plain(dev, b, sq, skv, hq, hkv, d, causal):
    g = torch.Generator(device=dev).manual_seed(b * 1000 + sq + skv)
    q, k, v = _bf16((b, sq, hq, d), g, dev), _bf16((b, skv, hkv, d), g, dev), \
        _bf16((b, skv, hkv, d), g, dev)
    before = _kernels.launch_counts["flash_fwd_lse"]
    out, lse, out_lo = ta.flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["flash_fwd_lse"] == before + 1
    ref_out, _, ref_lo = ta.reference_attention_lse(q, k, v, causal=causal)
    _close(out, ref_out)
    # out_lo: out's rounding residual, within half a bf16 ulp of out, and
    # out + out_lo the output before rounding
    assert out_lo.dtype == torch.bfloat16 and out_lo.shape == out.shape
    assert (out_lo.float().abs() <= 2 ** -7 * out.float().abs()).all()
    _close(out.float() + out_lo.float(), ref_out.float() + ref_lo.float())
    # lse against the plain log-sum-exp of the masked, scaled logits
    kr = k.float().repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * d ** -0.5
    if causal:
        mask = (torch.arange(sq, device=dev)[:, None] + skv - sq) >= torch.arange(skv, device=dev)
        logits = logits.masked_fill(~mask, float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_is_deterministic(dev, d):
    """Two launches on the same inputs give bitwise-equal out and lse: the
    kernel sums in a fixed order, with no atomics."""
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v = _bf16((2, 300, 8, d), g, dev), _bf16((2, 700, 2, d), g, dev), \
        _bf16((2, 700, 2, d), g, dev)
    runs = [ta.flash_attention_lse(q, k, v, causal=True) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


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
    lengths = torch.randint(1, max_pages * ps + 1, (b,), generator=g, dtype=torch.int32)
    lengths[0] = 1  # an inactive slot reading the trash page
    q, kp, vp, table, lengths = _paged_case(dev, lengths.tolist(), nh, nkv, d, ps, max_pages,
                                            retired=(0,), g=g, dev_seed=7)
    before = _kernels.launch_counts["paged_attention"]
    out = pd.paged_attention(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["paged_attention"] == before + 1
    _close(out, pd._paged_attention_reference(q, kp, vp, table, lengths, 1.0))


def _paged_case(dev, lengths, nh=16, nkv=4, d=128, ps=64, max_pages=32, retired=(), seed=0,
                g=None, dev_seed=None):
    """Inputs for ``paged_attention`` with each slot's own pages (random, in
    place in a pool of 1 + B * max_pages pages); ``retired`` slots keep an
    all-zero table row, so every row they read lies in trash page 0. ``g``
    (the CPU generator for the pages) and ``dev_seed`` default to ``seed``
    and ``seed + 1``."""
    b = len(lengths)
    g = torch.Generator().manual_seed(seed) if g is None else g
    total = 1 + b * max_pages
    perm = torch.randperm(total - 1, generator=g) + 1
    table = torch.zeros((b, max_pages), dtype=torch.int32)
    for s, n_rows in enumerate(lengths):
        if s not in retired:
            n = -(-n_rows // ps)
            table[s, :n] = perm[s * max_pages: s * max_pages + n]
    gd = torch.Generator(device=dev).manual_seed(seed + 1 if dev_seed is None else dev_seed)
    kp, vp = _bf16((nkv, total, ps, d), gd, dev), _bf16((nkv, total, ps, d), gd, dev)
    q = (torch.randn((b, nh, d), generator=gd, device=dev) * d ** -0.5).to(torch.bfloat16)
    return q, kp, vp, table.to(dev), torch.tensor(lengths, dtype=torch.int32, device=dev)


def _paged_check(args):
    before = _kernels.launch_counts["paged_attention"]
    out = pd.paged_attention(*args)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["paged_attention"] == before + 1
    _close(out, pd._paged_attention_reference(*args, 1.0))


def test_paged_attention_long_context(dev):
    """Few slots, long contexts: each slot's rows are split over many blocks
    and merged."""
    g = torch.Generator().manual_seed(11)
    lengths = torch.randint(1537, 2049, (4,), generator=g).tolist()
    _paged_check(_paged_case(dev, lengths, seed=11))


@pytest.mark.parametrize("ps,max_pages", [(16, 32), (64, 32), (16, 8), (64, 3), (48, 10),
                                          (24, 16)])
def test_paged_attention_split_edges(dev, ps, max_pages):
    """Lengths at the edges of the kernel's 128-row chunks, of its boxes (64,
    16 and 8 rows at page sizes 64, 48 and 24) and of the table."""
    full = max_pages * ps
    lengths = sorted({min(n, full) for n in (1, 63, 64, 65, 127, 128, 129, 256)} | {full})
    _paged_check(_paged_case(dev, lengths, ps=ps, max_pages=max_pages, seed=ps + max_pages))


def test_paged_attention_retired_slot(dev):
    """A retired slot keeps its position and an all-zero table row: 300 rows,
    all in trash page 0, read five times over."""
    _paged_check(_paged_case(dev, [300, 700, 300, 5], retired=(0, 2), seed=3))


def test_paged_attention_is_deterministic(dev):
    """Two launches on the same inputs give bitwise-equal outputs: the splits
    merge in a fixed order, with no atomics."""
    g = torch.Generator().manual_seed(5)
    args = _paged_case(dev, torch.randint(1, 2049, (6,), generator=g).tolist(), seed=5)
    runs = [pd.paged_attention(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


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


@pytest.mark.parametrize("ps", [4, 12])
def test_paged_attention_rejects_page_sizes_it_cannot_box(dev, ps):
    """The kernel loads whole TMA boxes of 8..128 rows of one page: a page
    size that is not a multiple of 8 raises."""
    args = _paged_case(dev, [5, 9], ps=ps, max_pages=4)
    with pytest.raises(ValueError, match="page size"):
        pd.paged_attention(*args)


def test_engine_refuses_page_sizes_the_kernel_cannot_box(dev):
    """The page size is checked when the engine is built, not at its first
    decode tick, for a config whose head dim the decode kernel tiles."""
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.serve.llm import LLMEngine

    with pytest.raises(ValueError, match="multiple of 8"):
        LLMEngine(_kernel_shaped(), device=dev, page_size=12)
    # tiny's decode runs the plain version: any page size will do
    LLMEngine(LlamaConfig.tiny(dtype=torch.bfloat16), device=dev, page_size=12).stop()


def _kernel_shaped(**kw):
    """A small config of llama_1b's attention shape: head_dim 128, 4 q heads
    per kv head, bf16."""
    from ray_tpu_torch.models.llama import LlamaConfig

    kw.setdefault("num_heads", 4)
    kw.setdefault("num_kv_heads", 1)
    return LlamaConfig(vocab_size=256, hidden_size=128 * kw["num_heads"], intermediate_size=256,
                       num_layers=2, max_seq_len=256, rope_theta=10000.0, **kw)


def _close_grad(out, ref):
    assert torch.isfinite(out).all()
    ref = ref.float()
    err = (out.float() - ref).abs()
    assert (err <= 1e-2 * ref.abs().max() + RTOL * ref.abs()).all(), err.max().item()


BWD_CASES = [
    (8, 2048, 2048, 16, 4, 128, True),   # the training shape of llama_1b
    (2, 100, 300, 16, 4, 128, True),     # ragged, Sq < Skv (bottom-right causal)
    (1, 77, 77, 4, 1, 128, True),        # ragged
    (1, 1, 65, 4, 1, 128, True),         # one query row
    (1, 100, 70, 8, 2, 128, False),      # non-causal, Sq > Skv
    (2, 128, 192, 8, 2, 128, False),     # non-causal, Sq < Skv
    # the 128-row q tile of dQ and the 128-key tile of dK/dV
    (1, 129, 129, 4, 1, 128, True),      # one row past a tile
    (1, 255, 255, 4, 1, 128, True),      # one row short of two tiles
    (3, 200, 200, 16, 4, 128, True),     # a map that ignored the batch would read the next one
    (2, 300, 700, 16, 4, 128, True),     # offset 400: not a tile multiple
    (1, 1, 2048, 4, 1, 128, True),       # one query row against many key tiles
    # D128 at groups 1 and 2
    (2, 196, 196, 4, 4, 128, False),     # group 1, ViT's 196 patches
    (1, 129, 129, 8, 4, 128, True),      # group 2, one row past a tile
    (1, 1, 200, 6, 6, 128, True),        # group 1, one query row
    # D64 (ViT: 768 / 12, 1024 / 16) at groups 1, 2 and 4
    (32, 196, 196, 16, 16, 64, False),   # ViT-L/16 at 224 px, batch 32
    (2, 196, 196, 4, 4, 64, False),      # group 1: 4 q tiles of 64 rows, the last 4 rows
    (3, 196, 196, 12, 12, 64, False),    # ViT-B's 12 heads; the lse boxes cross heads
    (2, 196, 196, 8, 2, 64, False),      # group 4
    (1, 77, 77, 4, 2, 64, True),         # group 2, ragged causal
    (2, 100, 300, 8, 8, 64, True),       # group 1, Sq < Skv (bottom-right causal)
    (1, 255, 255, 8, 4, 64, True),       # group 2, one row short of two tiles
    (1, 1, 65, 4, 1, 64, True),          # group 4, one query row
    (1, 1, 196, 2, 2, 64, False),        # group 1, one query row, not causal
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal", BWD_CASES)
def test_flash_bwd_matches_plain(dev, b, sq, skv, hq, hkv, d, causal):
    g = torch.Generator(device=dev).manual_seed(b * 1000 + sq + skv + 1)
    q, k, v = _bf16((b, sq, hq, d), g, dev), _bf16((b, skv, hkv, d), g, dev), \
        _bf16((b, skv, hkv, d), g, dev)
    dout = _bf16((b, sq, hq, d), g, dev)
    out, lse, out_lo = ta.flash_attention_lse(q, k, v, causal)
    before = {n: _kernels.launch_counts[n] for n in ("flash_bwd_dq", "flash_bwd_dkv")}
    dq, dk, dv = ta.flash_bwd(q, k, v, out, lse, dout, causal, out_lo=out_lo)
    torch.cuda.synchronize()
    assert all(_kernels.launch_counts[n] == c + 1 for n, c in before.items())
    want = ta.flash_bwd_reference(q, k, v, out, lse, dout, causal, out_lo=out_lo)
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        _close_grad(got, ref)


@pytest.mark.parametrize("hkv,d,causal", [(4, 128, True), (16, 64, False)])
def test_flash_bwd_is_deterministic(dev, hkv, d, causal):
    """Two launches on the same inputs give bitwise-equal dq, dk and dv: the
    kernels sum in a fixed order (the GQA group in registers), with no
    atomics."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = _bf16((2, 300, 16, d), g, dev), _bf16((2, 700, hkv, d), g, dev), \
        _bf16((2, 700, hkv, d), g, dev)
    dout = _bf16((2, 300, 16, d), g, dev)
    out, lse, out_lo = ta.flash_attention_lse(q, k, v, causal)
    runs = [ta.flash_bwd(q, k, v, out, lse, dout, causal, out_lo=out_lo) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_flash_bwd_rejects_what_it_does_not_take(dev):
    def case(b, sq, hq, hkv, d, dtype=torch.bfloat16):
        q = torch.randn(b, sq, hq, d, device=dev).to(dtype)
        k = torch.randn(b, sq, hkv, d, device=dev).to(dtype)
        lse = torch.zeros(b, hq, sq, device=dev)
        return q, k, k, q, lse, q
    with pytest.raises(ValueError, match="head_dim"):
        ta.flash_bwd(*case(1, 64, 8, 2, 32))
    with pytest.raises(ValueError, match="bfloat16"):
        ta.flash_bwd(*case(1, 64, 8, 2, 64, torch.float32))
    with pytest.raises(ValueError, match="multiple"):
        ta.flash_bwd(*case(1, 64, 8, 3, 128))


@pytest.mark.parametrize("b,sq,skv,causal", [(2, 256, 256, True), (1, 96, 160, True),
                                             (1, 64, 128, False)])
def test_flash_op_gradients_match_plain(dev, b, sq, skv, causal):
    """The op with a gradient launches the lse forward and both backward
    kernels once each; its gradients match autograd through the plain
    forward (fp32 on the same bf16 inputs)."""
    g = torch.Generator(device=dev).manual_seed(sq + skv)
    q, k, v = _bf16((b, sq, 8, 128), g, dev), _bf16((b, skv, 2, 128), g, dev), \
        _bf16((b, skv, 2, 128), g, dev)
    dout = _bf16((b, sq, 8, 128), g, dev)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    names = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
    before = {n: _kernels.launch_counts[n] for n in names}
    out = ta.attention(*leaves, causal=causal)
    out.backward(dout)
    torch.cuda.synchronize()
    assert [_kernels.launch_counts[n] - before[n] for n in names] == [0, 1, 1, 1]
    plain = [t.float().requires_grad_(True) for t in (q, k, v)]
    ta.reference_attention(*plain, causal=causal).backward(dout.float())
    for got, ref in zip(leaves, plain):
        _close_grad(got.grad, ref.grad.to(torch.bfloat16))


# --------------------------------------------------------------------------- #
# The dispatch rule on the card: shapes the kernels do not take run the plain
# versions, counted apart; the JAX package serves and trains them too.
# --------------------------------------------------------------------------- #
# Model logits and train metrics, bf16 on the card against fp32 on the CPU
# (chip_smoke.py's model-phase tolerance): max |diff| / max |fp32|.
MODEL_RTOL = 5e-2
KERNELS = ("flash_fwd", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv", "paged_attention")
PLAINS = ("attention_plain", "paged_attention_plain")


def _counts():
    return {n: _kernels.launch_counts[n] for n in KERNELS + PLAINS}


def _delta(before):
    return {n: c - before[n] for n, c in _counts().items() if c != before[n]}


def _tiny(dtype, **kw):
    from ray_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(dtype=dtype, **kw)


def _rel(a, b):
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.parametrize("shape,grad,want", [
    ((1, 64, 4, 2, 32), False, {"attention_plain": 1}),          # tiny
    ((1, 64, 4, 2, 32), True, {"attention_plain": 1}),
    ((1, 64, 12, 12, 64), True, {"flash_fwd_lse": 1, "flash_bwd_dq": 1,
                                 "flash_bwd_dkv": 1}),            # ViT-B's D64, group 1
    ((1, 64, 16, 4, 128), False, {"flash_fwd": 1}),               # llama_1b
    ((1, 64, 16, 4, 128), True, {"flash_fwd_lse": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}),
])
def test_attention_dispatch_counts(dev, shape, grad, want):
    b, s, hq, hkv, d = shape
    g = torch.Generator(device=dev).manual_seed(d + hq)
    q, k, v = _bf16((b, s, hq, d), g, dev), _bf16((b, s, hkv, d), g, dev), \
        _bf16((b, s, hkv, d), g, dev)
    leaves = [t.requires_grad_(grad) for t in (q, k, v)]
    before = _counts()
    out = ta.attention(*leaves, causal=True)
    if grad:
        out.float().sum().backward()
        assert all(torch.isfinite(t.grad).all() for t in leaves)
    torch.cuda.synchronize()
    assert _delta(before) == want
    _close(out.detach(), reference_attention(q.detach(), k.detach(), v.detach(), causal=True))


@pytest.mark.parametrize("nh,nkv,d,want", [(4, 2, 32, "paged_attention_plain"),
                                           (16, 4, 128, "paged_attention")])
def test_paged_dispatch_counts(dev, nh, nkv, d, want):
    q, kp, vp, table, lengths = _paged_case(dev, [5, 70, 129], nh, nkv, d, 16, 10, seed=d)
    before = _counts()
    out = pd._paged_attention(q[:, None], kp, vp, table, lengths, 1.0, None)
    torch.cuda.synchronize()
    assert _delta(before) == {want: 1}
    _close(out[:, 0], pd._paged_attention_reference(q, kp, vp, table, lengths, 1.0))


@pytest.mark.parametrize("hq,hkv,d,dtype,grad,match", [
    (16, 4, 128, torch.float32, False, "bfloat16"),   # fp32 at D128
    (16, 4, 128, torch.float32, True, "bfloat16"),
    (16, 6, 128, torch.bfloat16, True, "multiple"),   # Hq % Hkv != 0, with a gradient
    (12, 8, 64, torch.bfloat16, False, "multiple"),   # ... and at D64 without one
])
def test_attention_auto_raises_where_the_kernels_tile_but_do_not_take(dev, hq, hkv, d, dtype,
                                                                      grad, match):
    """A head dim the kernels tile never takes the plain version: a dtype or
    a head split they do not take raises, as under impl="flash"."""
    g = torch.Generator(device=dev).manual_seed(hq)
    q, k, v = (torch.randn((1, 64, h, d), generator=g, device=dev).to(dtype)
               .requires_grad_(grad) for h in (hq, hkv, hkv))
    before = _counts()
    with pytest.raises(ValueError, match=match):
        out = ta.attention(q, k, v, causal=True)
        out.float().sum().backward()
    assert not {n: c for n, c in _delta(before).items() if n in PLAINS}


def test_paged_dispatch_raises_where_the_kernel_tiles_but_does_not_take(dev):
    """D128 at group 2 or in fp32: the decode layer and the engine raise; the
    engine does so when it is built."""
    from ray_tpu_torch.serve.llm import LLMEngine

    before = _counts()
    q, kp, vp, table, lengths = _paged_case(dev, [5, 70], 16, 8, 128, 16, 10)
    with pytest.raises(ValueError, match="nh/n_kv 4"):
        pd._paged_attention(q[:, None], kp, vp, table, lengths, 1.0, None)
    q, kp, vp, table, lengths = _paged_case(dev, [5, 70], 16, 4, 128, 16, 10)
    with pytest.raises(ValueError, match="bfloat16"):
        pd._paged_attention(q[:, None].float(), kp.float(), vp.float(), table, lengths, 1.0,
                            None)
    assert not _delta(before)
    with pytest.raises(ValueError, match="nh/n_kv 4"):
        LLMEngine(_kernel_shaped(num_heads=4, num_kv_heads=2), device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        LLMEngine(_kernel_shaped(dtype=torch.float32), device=dev)


def test_tiny_engine_on_the_card_matches_the_cpu(dev):
    """fp32: greedy tokens equal the CPU's; bf16: prefill logits within
    MODEL_RTOL of the CPU's fp32. Every attention call runs a plain version."""
    from ray_tpu_torch.models import paged_decode as tpd
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = _tiny(torch.float32)
    params = llama_init(cfg, 3, "cpu")
    prompts, n_new = [[3, 14, 15, 92, 65], [1, 2, 3], list(range(20, 45))], 7
    kw = dict(num_slots=2, decode_chunk=4, max_seq_len=64, prefill_buckets=[16, 32],
              page_size=16)
    tokens = {}
    before = _counts()
    for where in ("cpu", dev):
        eng = LLMEngine(cfg, params, device=where, **kw)
        try:
            tokens[str(where)] = [eng.generate(p, n_new, timeout=120)["tokens"] for p in prompts]
        finally:
            eng.stop()
    counts = _delta(before)
    assert tokens["cpu"] == tokens[str(dev)]
    assert set(counts) == set(PLAINS), counts

    # bf16 prefill on the card against fp32 on the CPU, the same weights
    bf16 = _tiny(torch.bfloat16)
    toks = torch.randint(0, 256, (2, 32), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    lens = torch.tensor([32, 19], dtype=torch.int32)
    pages = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    logits = {}
    for where, c in (("cpu", cfg), (dev, bf16)):
        p = {k: (v.to(where, c.dtype) if torch.is_tensor(v)
                 else {n: w.to(where, c.dtype) for n, w in v.items()}) for k, v in params.items()}
        cache = tpd.init_paged_cache(c, 5, 16, dtype=c.dtype, device=where)
        logits[str(where)], _ = tpd.paged_prefill(p, cache, toks.to(where), pages.to(where),
                                                  lens.to(where), c, 16)
    assert torch.isfinite(logits[str(dev)]).all()
    assert _rel(logits[str(dev)], logits["cpu"]) <= MODEL_RTOL


def test_deployment_answers_on_the_card(dev):
    """LLMDeployment()'s defaults: model tiny, bf16, on the card."""
    from ray_tpu_torch.serve.llm import LLMDeployment

    before = _counts()
    dep = LLMDeployment()
    try:
        out = dep({"tokens": [5, 6, 7], "max_tokens": 6, "timeout": 120})
    finally:
        dep.stop()
    assert len(out["tokens"]) == 6 and all(0 <= t < 256 for t in out["tokens"])
    counts = _delta(before)
    assert set(counts) == set(PLAINS), counts


def test_tiny_train_step_on_the_card_matches_the_cpu(dev):
    """One bf16 train step of tiny on the card (plain attention with autograd
    through it) against the fp32 step on the CPU from the same weights:
    loss and grad_norm within MODEL_RTOL."""
    import numpy as np

    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.train.step import TrainState, default_optimizer, make_train_step

    opt = default_optimizer(lr=1e-2, warmup_steps=1, total_steps=50)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 64)))
    targets = torch.roll(tokens, -1, dims=1)
    weights = llama_init(_tiny(torch.bfloat16), 5, "cpu")
    metrics = {}
    for where, dtype in (("cpu", torch.float32), (dev, torch.bfloat16)):
        cfg = _tiny(dtype, remat=None)
        params = {k: (v.to(where, dtype) if torch.is_tensor(v)
                      else {n: w.to(where, dtype) for n, w in v.items()})
                  for k, v in weights.items()}
        state = TrainState(step=0, params=params, opt_state=opt.init(params))
        before = _counts()
        _, metrics[str(where)] = make_train_step(cfg, opt)(state, tokens.to(where),
                                                           targets.to(where))
    assert _delta(before) == {"attention_plain": cfg.num_layers}
    got, want = metrics[str(dev)], metrics["cpu"]
    assert abs(got["loss"].item() - want["loss"].item()) <= MODEL_RTOL * abs(want["loss"].item())
    assert abs(got["grad_norm"].item() - want["grad_norm"].item()) \
        <= MODEL_RTOL * want["grad_norm"].item()


def _small_vit(dtype):
    """A ViT of ViT-B's attention shape (head dim 64, one q head per kv
    head), small: hidden 128, 2 heads, 2 layers, 64 px in patches of 8."""
    from ray_tpu_torch.models.vit import ViTConfig

    return ViTConfig(image_size=64, patch_size=8, hidden_size=128, intermediate_size=256,
                     num_layers=2, num_heads=2, num_classes=10, dtype=dtype)


def test_small_vit_train_step_on_the_card_matches_the_cpu(dev):
    """Loss and gradients of a bf16 step on the card, through K1', K2 and K3
    once a layer, against fp32 on the CPU from the same weights: the loss
    and the global gradient norm within MODEL_RTOL; then one
    make_vit_train_step update and a no-grad forward through K1."""
    import numpy as np

    from ray_tpu_torch.models import vit as tv
    from ray_tpu_torch.train.step import _leaves, adamw, global_norm

    rng = np.random.default_rng(8)
    images = torch.from_numpy(rng.random((4, 64, 64, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, (4,)))
    weights = tv.vit_init(_small_vit(torch.float32), seed=9, device="cpu")
    got = {}
    for where, dtype in (("cpu", torch.float32), (dev, torch.bfloat16)):
        cfg = _small_vit(dtype)
        params = {k: (v.to(where, dtype) if torch.is_tensor(v)
                      else {n: w.to(where, dtype) for n, w in v.items()})
                  for k, v in weights.items()}
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        before = _counts()
        loss = tv.vit_loss(params, images.to(where), labels.to(where), cfg)
        got[str(where)] = (loss.item(), global_norm(torch.autograd.grad(loss, leaves)).item())
    L = cfg.num_layers
    assert _delta(before) == {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    (loss_c, norm_c), (loss_g, norm_g) = got["cpu"], got[str(dev)]
    assert abs(loss_g - loss_c) <= MODEL_RTOL * abs(loss_c)
    assert abs(norm_g - norm_c) <= MODEL_RTOL * norm_c

    step, init = tv.make_vit_train_step(cfg, adamw(1e-3))
    params, opt_state = init(seed=9, device=dev)
    before = _counts()
    params, opt_state, loss = step(params, opt_state, images.to(dev), labels.to(dev))
    with torch.no_grad():
        logits = tv.vit_forward(params, images.to(dev), cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(loss) and torch.isfinite(logits).all() and opt_state.count == 1
    assert _delta(before) == {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                              "flash_fwd": L}


def test_grpo_train_step_on_tiny_on_the_card(dev):
    import math

    from ray_tpu_torch.rl import GRPOConfig, GRPOTrainer

    def reward(prompt, completion):
        return sum(1 for t in completion if t < 128) / max(1, len(completion))

    before = _counts()
    trainer = GRPOTrainer(_tiny(torch.bfloat16, remat=None), reward,
                          grpo=GRPOConfig(group_size=2, max_new_tokens=8), num_slots=4)
    try:
        for _ in range(2):
            m = trainer.train_step([[1, 2, 3], [9, 8, 7, 6, 5]])
            assert all(math.isfinite(v) for v in m.values()), m
    finally:
        trainer.stop()
    counts = _delta(before)
    assert set(counts) == set(PLAINS), counts


# --------------------------------------------------------------------------- #
# The mesh (ray_tpu_torch.parallel) at world size 1 on NCCL
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mesh1():
    """make_mesh(MeshConfig()) on a process group of world size 1 (NCCL),
    torn down after the module's mesh tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: NCCL and the CUDA kernels")
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh(MeshConfig())
    finally:
        dist.destroy_process_group()


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _mesh_config(which):
    from ray_tpu_torch.models.llama import LlamaConfig

    if which == "tiny":  # head dim 32: the plain attention, with autograd through it
        return _tiny(torch.bfloat16, remat=None)
    # llama_1b's attention (16 q heads over 4 kv heads of 128) in 2 narrow layers
    return LlamaConfig(vocab_size=1024, hidden_size=2048, intermediate_size=1024, num_layers=2,
                       num_heads=16, num_kv_heads=4, max_seq_len=512, dtype=torch.bfloat16,
                       remat="save_attn")


@pytest.mark.parametrize("which", ["tiny", "llama_1b_heads"])
def test_sharded_train_step_on_the_card_matches_unsharded(mesh1, which):
    """Under the world-size-1 mesh: the loss and every gradient of
    llama_loss(..., mesh=mesh) against the unsharded port's, within
    MODEL_RTOL of the largest element; then one train step of each from the
    same seed, loss and grad_norm within 1e-3. The sharded step launches
    what the unsharded one does: tiny's head dim 32 the plain attention,
    llama_1b's heads K1', K2 and K3 once a layer."""
    import numpy as np

    from ray_tpu_torch.models.llama import llama_init, llama_logical_axes, llama_loss
    from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, shard_pytree
    from ray_tpu_torch.train.step import (_leaves, default_optimizer, make_train_state_factory,
                                          make_train_step)

    cfg = _mesh_config(which)
    L = cfg.num_layers
    want = ({"attention_plain": L} if which == "tiny" else
            {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L})
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 256)))
    tokens = tokens.cuda()
    targets = torch.roll(tokens, -1, dims=1)
    params = llama_init(cfg, 3, "cuda")
    sharded = shard_pytree(params, llama_logical_axes(cfg), mesh1, DEFAULT_LLM_RULES)
    results = {}
    for name, p, kw in (("unsharded", params, {}), ("sharded", sharded, {"mesh": mesh1})):
        leaves = _leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        before = _counts()
        loss = llama_loss(p, tokens, targets, cfg, **kw)
        grads = torch.autograd.grad(loss, leaves)
        assert _delta(before) == want
        results[name] = (_whole(loss), [_whole(g) for g in grads])
    (l0, g0), (l1, g1) = results["unsharded"], results["sharded"]
    assert abs(l1.item() - l0.item()) <= 1e-3 * abs(l0.item())
    for a, b in zip(g1, g0):
        assert torch.isfinite(a).all() and _rel(a, b) <= MODEL_RTOL

    opt = default_optimizer(lr=1e-2, warmup_steps=1, total_steps=50)
    metrics = {}
    for name, mesh in (("unsharded", None), ("sharded", mesh1)):
        state = make_train_state_factory(cfg, opt, mesh=mesh)(seed=3, device="cuda")
        before = _counts()
        _, metrics[name] = make_train_step(cfg, opt, mesh=mesh)(state, tokens, targets)
        assert _delta(before) == want
    m0, m1 = metrics["unsharded"], metrics["sharded"]
    for k in ("loss", "grad_norm"):
        assert abs(m1[k].item() - m0[k].item()) <= 1e-3 * abs(m0[k].item()), k


def test_sharded_eval_step_launches_the_forward_kernel(mesh1):
    """make_eval_step(mesh=mesh) at llama_1b's heads: one flash_fwd a layer
    (no gradient), and the unsharded eval's loss within 1e-3."""
    import numpy as np

    from ray_tpu_torch.models.llama import llama_init, llama_logical_axes
    from ray_tpu_torch.parallel.sharding import DEFAULT_LLM_RULES, shard_pytree
    from ray_tpu_torch.train.step import make_eval_step

    cfg = _mesh_config("llama_1b_heads")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 256)))
    tokens = tokens.cuda()
    targets = torch.roll(tokens, -1, dims=1)
    params = llama_init(cfg, 4, "cuda")
    want = make_eval_step(cfg)(params, tokens, targets)
    sharded = shard_pytree(params, llama_logical_axes(cfg), mesh1, DEFAULT_LLM_RULES)
    before = _counts()
    got = make_eval_step(cfg, mesh=mesh1)(sharded, tokens, targets)
    assert _delta(before) == {"flash_fwd": cfg.num_layers}
    assert abs(got.item() - want.item()) <= 1e-3 * abs(want.item())
