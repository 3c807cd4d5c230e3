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
    _check_fwd_lse(q, k, v, causal, out, lse, out_lo)


def _check_fwd_lse(q, k, v, causal, out, lse, out_lo):
    """The training forward's out, out_lo and lse against the plain versions."""
    (_, sq, hq, d), (_, skv, hkv, _), dev = q.shape, k.shape, q.device
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


D256_FWD_CASES = [  # (b, sq, skv, hq, hkv, causal), head dim 256
    (8, 128, 128, 8, 2, True),     # the c5 engine's prefill: one q tile a block
    (2, 100, 300, 8, 2, True),     # group 4, ragged, Sq < Skv (offset 200)
    (1, 196, 196, 4, 4, False),    # group 1, ViT's 196 rows: the second q tile's last rows
    (1, 65, 200, 8, 1, True),      # group 8, one row past the first 64-row warpgroup
    (2, 64, 64, 8, 8, False),      # group 1, the second warpgroup's rows all past Sq
    (1, 1, 257, 4, 1, True),       # one query row: the last 64-key tile holds one key
    (3, 200, 200, 8, 2, True),     # a map that ignored the batch would read the next one
    (1, 129, 320, 16, 2, False),   # group 8, Sq < Skv, not causal
    (1, 300, 700, 4, 2, True),     # offset 400: not a multiple of the 64-key tile
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,causal", D256_FWD_CASES)
def test_flash_fwd_d256_matches_plain(dev, b, sq, skv, hq, hkv, causal):
    """The tensor-core forward at head dim 256 (64-key tiles, 256 threads),
    with and without lse and out_lo, against the plain versions at the bf16
    tolerances of test_flash_fwd_matches_plain; each call launches
    flash_fwd or flash_fwd_lse once and no CUDA-core kernel; two launches
    give bitwise-equal results."""
    g = torch.Generator(device=dev).manual_seed(b * 1000 + sq + skv + 256)
    q, k, v = _bf16((b, sq, hq, 256), g, dev), _bf16((b, skv, hkv, 256), g, dev), \
        _bf16((b, skv, hkv, 256), g, dev)
    before = _counts()
    out = flash_attention(q, k, v, causal=causal)
    again = flash_attention(q, k, v, causal=causal)
    trained = ta.flash_attention_lse(q, k, v, causal=causal)
    trained_again = ta.flash_attention_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _delta(before) == {"flash_fwd": 2, "flash_fwd_lse": 2}
    _close(out, reference_attention(q, k, v, causal=causal))
    _check_fwd_lse(q, k, v, causal, *trained)
    assert torch.equal(out, again) and torch.equal(out, trained[0])
    for a, b_ in zip(trained, trained_again):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("d", [64, 128, 256])
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
    q = torch.randn(1, 8, 2, 128, device=dev).half()  # fp16: neither kernel family takes it
    with pytest.raises(ValueError, match="bfloat16 or float32"):
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
    q = torch.randn(2, 8, 128, device=dev).half()
    pool = torch.zeros(2, 3, 16, 128, device=dev).half()
    table = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    lengths = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        pd.paged_attention(q, pool, pool, table, lengths)
    qb, pb = q.to(torch.bfloat16), pool.to(torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        pd.paged_attention(qb, pb, pb, table.long(), lengths)
    with pytest.raises(ValueError, match="nh % n_kv"):
        q6 = torch.zeros(2, 6, 128, device=dev, dtype=torch.bfloat16)
        p4 = torch.zeros(4, 3, 16, 128, device=dev, dtype=torch.bfloat16)
        pd.paged_attention(q6, p4, p4, table, lengths)
    with pytest.raises(ValueError, match="D 128 or 256"):
        q64 = torch.zeros(2, 8, 64, device=dev, dtype=torch.bfloat16)
        p64 = torch.zeros(2, 3, 16, 64, device=dev, dtype=torch.bfloat16)
        pd.paged_attention(q64, p64, p64, table, lengths)
    with pytest.raises(ValueError, match="D 128 or 256"):  # above 256: the limit left
        q384 = torch.zeros(2, 8, 384, device=dev, dtype=torch.bfloat16)
        p384 = torch.zeros(2, 3, 16, 384, device=dev, dtype=torch.bfloat16)
        pd.paged_attention(q384, p384, p384, table, lengths)


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
    # D256 (the 128-row q tile and 64-key K/V tiles of dQ, the 64-key block of
    # dK/dV) at groups 1, 4 and 8
    (2, 128, 128, 8, 2, 256, True),      # group 4: the c5 D256 config's prefill heads
    (1, 1024, 1024, 8, 2, 256, True),    # group 4, 16 key tiles through the 3-buffer ring
    (1, 100, 300, 8, 2, 256, True),      # ragged, Sq < Skv (bottom-right causal)
    (1, 129, 129, 4, 1, 256, True),      # one row past a q tile
    (2, 196, 196, 4, 4, 256, False),     # group 1, not causal, ragged
    (1, 65, 200, 8, 1, 256, True),       # group 8, Sq < Skv
    (1, 1, 65, 8, 1, 256, True),         # group 8, one query row
    (1, 1, 2048, 4, 1, 256, True),       # one query row against many key tiles
    (1, 100, 70, 8, 2, 256, False),      # not causal, Sq > Skv
    (1, 63, 63, 2, 2, 256, True),        # fewer keys than one tile
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


@pytest.mark.parametrize("hkv,d,causal,dtype", [
    (4, 128, True, torch.bfloat16), (16, 64, False, torch.bfloat16),
    (2, 256, True, torch.bfloat16),
    # fp32 (flash_bwd_f32.cu): dK/dV over 4 splits of the group and a second pass at
    # group 4 (11 key tiles x 4 kv heads x 2 = 88 blocks), the whole group a block
    # at group 1
    (4, 128, True, torch.float32), (16, 64, False, torch.float32),
    (2, 256, True, torch.float32)])
def test_flash_bwd_is_deterministic(dev, hkv, d, causal, dtype):
    """Two launches on the same inputs give bitwise-equal dq, dk and dv: the
    kernels sum in a fixed order (the GQA group in registers, fp32's splits
    in split order), with no atomics."""
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v, dout = (torch.randn(s, generator=g, device=dev).to(dtype) for s in
                     ((2, 300, 16, d), (2, 700, hkv, d), (2, 700, hkv, d), (2, 300, 16, d)))
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
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        ta.flash_bwd(*case(1, 64, 8, 2, 64, torch.float16))
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
KERNELS += tuple(f"{n}_tf32x3" for n in KERNELS[:4]) + ("paged_attention_f32",)
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
    ((1, 64, 8, 2, 256), False, {"flash_fwd": 1}),                # D256: the tensor-core forward
    ((1, 64, 8, 2, 256), True, {"flash_fwd_lse": 1, "flash_bwd_dq": 1,
                                "flash_bwd_dkv": 1}),             # ... and the tensor-core backward
    ((2, 100, 8, 1, 256), True, {"flash_fwd_lse": 1, "flash_bwd_dq": 1,
                                 "flash_bwd_dkv": 1}),            # group 8, ragged
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
    (16, 4, 128, torch.float16, False, "bfloat16 or float32"),   # fp16 at D128
    (16, 4, 128, torch.float16, True, "bfloat16 or float32"),
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
    """fp16 at D128: the decode layer and the engine raise; the engine does
    so when it is built. D384 (a multiple of 128 above 256, which no kernel
    takes: fault C10) runs the plain decode instead."""
    from ray_tpu_torch.serve.llm import LLMEngine

    before = _counts()
    q, kp, vp, table, lengths = _paged_case(dev, [5, 70], 4, 2, 384, 16, 10)
    out = pd._paged_attention(q[:, None], kp, vp, table, lengths, 1.0, None)
    torch.cuda.synchronize()
    assert _delta(before) == {"paged_attention_plain": 1}
    _close(out[:, 0], pd._paged_attention_reference(q, kp, vp, table, lengths, 1.0))
    before = _counts()
    q, kp, vp, table, lengths = _paged_case(dev, [5, 70], 16, 4, 128, 16, 10)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        pd._paged_attention(q[:, None].half(), kp.half(), vp.half(), table, lengths, 1.0,
                            None)
    assert not _delta(before)
    LLMEngine(_kernel_shaped(num_heads=2, num_kv_heads=1, head_dim=384), device=dev).stop()
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        LLMEngine(_kernel_shaped(dtype=torch.float16), device=dev)


@pytest.mark.parametrize("head_dim", [384, 512])
def test_paged_engine_above_d256_answers_through_the_plain_decode(dev, head_dim):
    """Fault C10: a bf16 paged engine at a head dim no decode kernel takes
    (a multiple of 128 above 256, as the JAX package's rule sends to its
    kernel) is built and answers, its decode through the plain version
    (counted as paged_attention_plain) and its prefill through the plain
    attention (attention_plain), and launches no kernel."""
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = _kernel_shaped(num_heads=4, num_kv_heads=1, head_dim=head_dim)
    params = llama_init(cfg, 3, dev)
    before = _counts()
    eng = LLMEngine(cfg, params, device=dev, num_slots=2, max_seq_len=128, page_size=16,
                    prefill_buckets=[64])
    try:
        got = [eng.generate(p, max_tokens=6, timeout=120)["tokens"]
               for p in ([3, 1, 4, 1, 5], list(range(7, 40)))]
    finally:
        eng.stop()
    counts = _delta(before)
    assert counts.get("paged_attention_plain", 0) > 0, counts
    assert set(counts) <= set(PLAINS), counts
    assert all(len(t) == 6 and all(0 <= x < cfg.vocab_size for x in t) for t in got)


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


def test_runtime_task_and_trainer_on_the_card(dev, tmp_path):
    """The in-process runtime on the card: the GPU resource counts the
    cards, a num_gpus=1 task gets a CUDA tensor zero-copy (the same
    data_ptr), and a one-worker GpuTrainer (use_gpu) trains a tiny bf16
    Llama at head dim 128 on its thread: 3 steps, each launching K1', K2
    and K3 once a layer and no plain attention."""
    import math

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.train import GpuTrainer, RunConfig, ScalingConfig

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512, num_layers=2,
                      num_heads=2, num_kv_heads=1, max_seq_len=256, dtype=torch.bfloat16,
                      remat="save_attn")
    L = cfg.num_layers
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        assert ray_tpu_torch.cluster_resources()["GPU"] == torch.cuda.device_count()
        x = torch.randn((64, 64), device=dev).to(torch.bfloat16)

        @ray_tpu_torch.remote(num_gpus=1)
        def where(t):
            return t.data_ptr(), t.device.type

        assert ray_tpu_torch.get(where.remote(x)) == (x.data_ptr(), "cuda")
        assert ray_tpu_torch.get(ray_tpu_torch.put(x)) is x

        def train_fn(config):
            from ray_tpu_torch import _kernels
            from ray_tpu_torch.train import session
            from ray_tpu_torch.train.step import (default_optimizer, make_train_state_factory,
                                                  make_train_step)

            opt = default_optimizer(lr=1e-2, warmup_steps=1, total_steps=50)
            state = make_train_state_factory(cfg, opt)(seed=0, device="cuda")
            step = make_train_step(cfg, opt)
            tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 128))).cuda()
            targets = torch.roll(tokens, -1, dims=1)
            for i in range(3):
                before = dict(_kernels.launch_counts)
                state, metrics = step(state, tokens, targets)
                session.report({"step": i, "loss": metrics["loss"].item(),
                                "launches": {n: c - before.get(n, 0)
                                             for n, c in _kernels.launch_counts.items()
                                             if c != before.get(n, 0)}})

        before = _counts()
        r = GpuTrainer(train_fn, scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
                       run_config=RunConfig(name="tiny", storage_path=str(tmp_path))).fit()
        assert r.error is None, r.error
        want = {"flash_fwd_lse": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
        assert [m["launches"] for m in r.metrics_history] == [want] * 3
        assert all(math.isfinite(m["loss"]) for m in r.metrics_history)
        assert _delta(before) == {n: 3 * c for n, c in want.items()}
    finally:
        ray_tpu_torch.shutdown()


def test_llm_deployment_via_serve_on_the_card(dev):
    """A tiny bf16 LLMDeployment behind serve.run on a num_gpus=1 replica
    gives the direct deployment's greedy tokens; its attention runs the
    plain versions (head dim 32, by the dispatch rule)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init
    from ray_tpu_torch.serve.llm import LLMDeployment

    params = llama_init(LlamaConfig.tiny(), 3, dev)
    kw = dict(model="tiny", num_slots=2, decode_chunk=4, max_seq_len=64, params=params)
    prompts = [[3, 14, 15, 92, 65], [1, 2, 3], list(range(20, 45))]
    direct = LLMDeployment(**kw)
    try:
        want = [direct.generate({"tokens": p, "max_tokens": 6, "timeout": 120})["tokens"]
                for p in prompts]
    finally:
        direct.stop()
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        before = _counts()
        app = serve.deployment(LLMDeployment, name="llm").options(
            ray_actor_options={"num_gpus": 1}).bind(**kw)
        handle = serve.run(app, http=False)
        got = [handle.generate.remote({"tokens": p, "max_tokens": 6, "timeout": 120})
               .result(timeout=120)["tokens"] for p in prompts]
        counts = _delta(before)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
    assert got == want
    assert set(counts) == set(PLAINS), counts


def test_dqn_update_on_the_card_matches_the_cpu(dev):
    """One DQN update (DQNConfig(): 128x128, double-Q, prioritized weights)
    in fp32 on the card against the CPU's from the same parameters and
    batch: loss, td and parameters within 1e-4 relative."""
    import numpy as np

    from ray_tpu_torch.rl import dqn
    from ray_tpu_torch.train.step import _leaves, adamw

    cfg = dqn.DQNConfig()
    rng = np.random.default_rng(0)
    B = cfg.batch_size
    batch = {"obs": rng.standard_normal((B, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, B), "rewards": np.ones(B, np.float32),
             "next_obs": rng.standard_normal((B, 4)).astype(np.float32),
             "dones": (rng.random(B) < 0.1).astype(np.float32),
             "weights": rng.uniform(0.2, 1.0, B).astype(np.float32)}
    online = dqn.q_init(4, 2, cfg.hidden, seed=0, device="cpu")
    target = dqn.q_init(4, 2, cfg.hidden, seed=1, device="cpu")
    out = {}
    for where in ("cpu", dev):
        p = dqn.params_to(online, where, copy=True)
        opt = adamw(cfg.lr)
        state = opt.init(dqn.as_tree(p))
        _, _, loss, td = dqn.make_dqn_update(cfg, opt)(
            p, dqn.params_to(target, where, copy=True), state, batch)
        out[str(where)] = (loss.cpu(), td.cpu(), [t.cpu() for t in _leaves(dqn.as_tree(p))])
    (lc, tc, pc), (lg, tg, pg) = out["cpu"], out[str(dev)]
    assert p[0]["w"].device.type == "cuda"
    assert _rel(lg, lc) <= 1e-4 and _rel(tg, tc) <= 1e-4
    assert max(_rel(a, b) for a, b in zip(pg, pc)) <= 1e-4


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


# --------------------------------------------------------------------------- #
# Fault C5: any GQA group and head dim 256 on the decode kernel, the fp32
# kernels at D64/128/256 (the 3xTF32 forward and backward of flash_fwd_f32.cu
# and flash_bwd_f32.cu, the decode of paged_attention_f32.cu), and bf16 at
# D256.
# fp32 kernels against the plain versions (fp32 math, full fp32 products) at
# the JAX tests' fp32 tolerance: |kernel - plain| <= 2e-5 + 2e-5 |plain|.
# --------------------------------------------------------------------------- #
F32_TOL = 2e-5


def _close_f32(out, ref):
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    err = (out - ref.float()).abs()
    assert (err <= F32_TOL + F32_TOL * ref.float().abs()).all(), err.max().item()


@pytest.mark.parametrize("nh,nkv,d", [(16, 16, 128), (16, 8, 128), (16, 2, 128), (16, 1, 128),
                                      (32, 1, 128), (8, 2, 256), (16, 4, 256)])
def test_paged_attention_any_group_matches_plain(dev, nh, nkv, d):
    """The split and merge kernels at groups 1, 2, 8, 16 and 32 (D128) and at
    D256: the serving table (page size 64, lengths 1..512 of a 32-page row)
    and a long ragged shape split over many blocks; bitwise repeatable."""
    g = torch.Generator().manual_seed(nh * 7 + nkv + d)
    for lengths in (torch.randint(1, 513, (16,), generator=g).tolist(),
                    torch.randint(1537, 2049, (3,), generator=g).tolist()):
        args = _paged_case(dev, lengths, nh, nkv, d, seed=nh + d)
        _paged_check(args)
        runs = [pd.paged_attention(*args) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])


def _f32_case(shape, seed, dev, dtype=torch.float32):
    b, sq, skv, hq, hkv, d, _ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d), (b, sq, hq, d))]


SIMT_CASES = [  # (b, sq, skv, hq, hkv, d, causal)
    (2, 100, 300, 8, 2, 64, True),    # ragged, Sq < Skv, bottom-right causal
    (1, 129, 129, 4, 4, 128, True),   # group 1, one row past a 16-row tile
    (2, 77, 50, 4, 1, 128, False),    # non-causal, Sq > Skv
    (1, 65, 200, 8, 1, 256, True),    # group 8 at D256
    (2, 96, 96, 2, 2, 256, False),
]


@pytest.mark.parametrize("shape", SIMT_CASES)
def test_simt_kernels_fp32_match_plain(dev, shape):
    """The forward (with and without lse), dQ and dK/dV in fp32 against the
    plain versions at 2e-5, each launching its 3xTF32 tensor-core kernel
    once (flash_fwd_f32.cu, flash_bwd_f32.cu)."""
    causal, scale = shape[-1], shape[5] ** -0.5
    q, k, v, dout = _f32_case(shape, sum(shape[:6]), dev)
    before = _counts()
    out = flash_attention(q, k, v, causal=causal)
    out_l, lse, out_lo = ta.flash_attention_lse(q, k, v, causal)
    delta = ta._delta(out_l, dout, out_lo)
    dq = ta.flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = ta.flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert _delta(before) == {"flash_fwd_tf32x3": 1, "flash_fwd_lse_tf32x3": 1,
                              "flash_bwd_dq_tf32x3": 1, "flash_bwd_dkv_tf32x3": 1}
    ref, ref_lse, _ = ta.reference_attention_lse(q, k, v, causal)
    _close_f32(out, ref)
    _close_f32(out_l, ref)
    _close_f32(lse, ref_lse)
    assert not out_lo.any()
    _close_f32(dq, ta.flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal, scale))
    for got, want in zip((dk, dv), ta.flash_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                                               causal, scale)):
        _close_f32(got, want)


F32_BWD_CASES = [  # (b, sq, skv, hq, hkv, d, causal): flash_bwd_f32.cu
    (2, 512, 512, 16, 4, 128, True),   # the c5 fp32 train step: dK/dV in 4 splits
    (1, 1024, 1024, 4, 4, 128, True),  # group 1, 32 key tiles of dQ, 32 q tiles of dK/dV
    (1, 4096, 4096, 8, 2, 128, True),  # dK/dV summed over 4 x 4096 q rows: the fp32 adds
    (2, 100, 300, 8, 2, 128, True),    # ragged, Sq < Skv, bottom-right causal
    (2, 77, 50, 4, 1, 128, False),     # not causal, Sq > Skv
    (1, 1, 65, 8, 1, 128, True),       # one query row, group 8
    (1, 20, 20, 8, 8, 128, False),     # fewer keys than a tile
    (2, 196, 196, 16, 16, 64, False),  # D64, group 1, ViT's 196 rows
    (1, 129, 129, 8, 2, 64, True),     # D64, one row past a tile
    (1, 300, 700, 8, 1, 64, True),     # D64, group 8, Sq < Skv
    (1, 1, 200, 4, 4, 64, False),      # D64, one query row, not causal
    (1, 1024, 1024, 8, 2, 256, True),  # D256, 32 key tiles through the one-stage ring
    (2, 96, 96, 2, 2, 256, False),     # D256, group 1
    (1, 65, 200, 8, 1, 256, True),     # D256, group 8, Sq < Skv
    (1, 100, 70, 4, 1, 256, False),    # D256, not causal, Sq > Skv
    (1, 20, 20, 4, 1, 256, True),      # D256, fewer keys than a tile
]


@pytest.mark.parametrize("shape", F32_BWD_CASES)
def test_flash_bwd_fp32_matches_plain(dev, shape):
    """dQ and dK/dV in fp32 on the tensor cores (3xTF32) against the plain
    backward in full fp32 at 2e-5, one launch each."""
    causal, scale = shape[-1], shape[5] ** -0.5
    q, k, v, dout = _f32_case(shape, sum(shape[:6]) + 7, dev)
    out, lse, out_lo = ta.flash_attention_lse(q, k, v, causal)
    delta = ta._delta(out, dout, out_lo)
    before = _counts()
    dq = ta.flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = ta.flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale)
    torch.cuda.synchronize()
    assert _delta(before) == {"flash_bwd_dq_tf32x3": 1, "flash_bwd_dkv_tf32x3": 1}
    _close_f32(dq, ta.flash_bwd_dq_reference(q, k, v, dout, lse, delta, causal, scale))
    for got, want in zip((dk, dv), ta.flash_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                                               causal, scale)):
        _close_f32(got, want)


@pytest.mark.parametrize("shape", [(2, 100, 300, 8, 2, 256, True), (1, 196, 196, 4, 4, 256, False),
                                   (1, 65, 200, 8, 1, 256, True)])
def test_flash_bwd_d256_kernels_match_plain(dev, shape):
    """bf16 at D256: the tensor-core forward (flash_fwd.cu) writes lse and
    out_lo, and the tensor-core backward kernels' D256 instances
    (flash_bwd.cu), fed by them, give the plain backward's gradients at the
    bf16 tolerances of the kernels' tests; bitwise repeatable."""
    causal = shape[-1]
    q, k, v, dout = _f32_case(shape, sum(shape[:6]), dev, torch.bfloat16)
    before = _counts()
    out, lse, out_lo = ta.flash_attention_lse(q, k, v, causal)
    grads = ta.flash_bwd(q, k, v, out, lse, dout, causal, out_lo=out_lo)
    again = ta.flash_bwd(q, k, v, out, lse, dout, causal, out_lo=out_lo)
    torch.cuda.synchronize()
    assert _delta(before) == {"flash_fwd_lse": 1, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    ref_out, ref_lse, _ = ta.reference_attention_lse(q, k, v, causal)
    _close(out, ref_out)
    assert (lse - ref_lse).abs().max().item() <= 1e-3 + 1e-4 * ref_lse.abs().max().item()
    want = ta.flash_bwd_reference(q, k, v, out, lse, dout, causal, out_lo=out_lo)
    for got, same, ref in zip(grads, again, want):
        assert got.dtype == torch.bfloat16 and torch.equal(got, same)
        _close_grad(got, ref)


@pytest.mark.parametrize("nh,nkv,d", [(8, 2, 64), (16, 16, 128), (16, 4, 128), (8, 2, 256)])
def test_simt_paged_attention_fp32_matches_plain(dev, nh, nkv, d):
    """The fp32 decode kernels (paged_attention_f32.cu) at 2e-5, with a
    retired slot and a page size (12) that is no multiple of 8."""
    g = torch.Generator().manual_seed(d + nh)
    lengths = torch.randint(1, 40 * 12 + 1, (6,), generator=g).tolist()
    q, kp, vp, table, lengths = _paged_case(dev, lengths, nh, nkv, d, 12, 40, retired=(1,),
                                            g=g, dev_seed=d)
    args = (q.float(), kp.float(), vp.float(), table, lengths)
    before = _counts()
    out = pd.paged_attention(*args)
    torch.cuda.synchronize()
    assert _delta(before) == {"paged_attention_f32": 1}
    _close_f32(out, pd._paged_attention_reference(*args, 1.0))


@pytest.mark.parametrize("nh,nkv,d,ps", [(16, 16, 128, 64), (16, 4, 128, 64), (16, 2, 128, 64),
                                         (32, 1, 128, 64), (8, 2, 64, 12), (8, 1, 256, 12),
                                         (16, 4, 256, 64), (8, 8, 64, 64)])
def test_paged_attention_fp32_long_and_bitwise(dev, nh, nkv, d, ps):
    """The fp32 decode at groups 1, 4, 8 and 32 and D64/128/256: the serving
    table (lengths 1..512, a retired slot, slots split over blocks and
    merged) and 4 slots of 1537..2048 rows, at 2e-5, two launches bitwise
    equal."""
    g = torch.Generator().manual_seed(nh * 7 + nkv + d + ps)
    for lengths, max_pages in ((torch.randint(1, 513, (8,), generator=g).tolist(), -(-512 // ps)),
                               (torch.randint(1537, 2049, (4,), generator=g).tolist(),
                                -(-2048 // ps))):
        q, kp, vp, table, lengths = _paged_case(dev, lengths, nh, nkv, d, ps, max_pages,
                                                retired=(1,), g=g, dev_seed=d + ps)
        args = (q.float(), kp.float(), vp.float(), table, lengths)
        before = _counts()
        runs = [pd.paged_attention(*args) for _ in range(2)]
        torch.cuda.synchronize()
        assert _delta(before) == {"paged_attention_f32": 2}
        assert torch.equal(runs[0], runs[1])
        _close_f32(runs[0], pd._paged_attention_reference(*args, 1.0))


def _reference_lse_by_batch(q, k, v, causal):
    """reference_attention_lse one batch element at a time (the logits of
    B8 S4096 at 16 heads would take 8.6 GB at once)."""
    parts = [ta.reference_attention_lse(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal)
             for i in range(q.shape[0])]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


@pytest.mark.parametrize("shape", [(8, 2048, 2048, 16, 4, 128, True),
                                   (8, 4096, 4096, 16, 4, 128, True),
                                   (2, 512, 512, 16, 4, 128, True),
                                   (2, 300, 700, 8, 1, 64, True), (1, 1, 200, 8, 8, 256, False),
                                   (2, 196, 196, 16, 16, 64, False),
                                   (1, 1024, 1024, 8, 2, 256, True)])
def test_flash_fwd_fp32_long_and_bitwise(dev, shape):
    """The fp32 forward (flash_fwd_f32.cu, 3xTF32) at llama_1b's training
    shape and at S4096 (the longest sums over keys), the c5 train shape, and
    D64/D256 at groups 1, 4 and 8: out and lse at 2e-5 against the plain
    forward; K1 and K1' each launched twice, bitwise equal, and K1's out
    equal to K1''s."""
    causal = shape[-1]
    q, k, v, _ = _f32_case(shape, sum(shape[:6]) + 3, dev)
    before = _counts()
    outs = [flash_attention(q, k, v, causal=causal) for _ in range(2)]
    fwd = [ta.flash_attention_lse(q, k, v, causal) for _ in range(2)]
    torch.cuda.synchronize()
    assert _delta(before) == {"flash_fwd_tf32x3": 2, "flash_fwd_lse_tf32x3": 2}
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], fwd[0][0])
    assert all(torch.equal(a, b) for a, b in zip(fwd[0], fwd[1]))
    assert not fwd[0][2].any()
    ref, ref_lse = _reference_lse_by_batch(q, k, v, causal)
    _close_f32(outs[0], ref)
    _close_f32(fwd[0][1], ref_lse)


@pytest.mark.parametrize("dtype,nkv,head_dim", [
    (torch.float32, 4, None), (torch.float32, 2, None), (torch.float32, 1, None),
    (torch.bfloat16, 4, None), (torch.bfloat16, 1, None), (torch.bfloat16, 2, 256)])
def test_c5_engine_on_the_card(dev, dtype, nkv, head_dim):
    """A narrow 2-layer config at groups 4, 2 and 8 (fp32) and 1 and 4 (bf16),
    and at D256 (bf16): the engine is built and answers, through the kernels
    only (the prefill through the tensor-core forward in bf16, D256 too, and
    the 3xTF32 forward in fp32); in fp32 the greedy tokens equal the
    CPU's."""
    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.serve.llm import LLMEngine

    cfg = _kernel_shaped(num_heads=8, num_kv_heads=nkv, dtype=dtype,
                         **({"head_dim": head_dim} if head_dim else {}))
    params = llama_init(cfg, 3, "cpu")  # the same weights on both devices
    prompts = [[3, 1, 4, 1, 5], list(range(7, 40))]
    before = _counts()
    eng = LLMEngine(cfg, params, device=dev, num_slots=2, max_seq_len=128, page_size=16,
                    prefill_buckets=[64])
    try:
        got = [eng.generate(p, max_tokens=6, timeout=120)["tokens"] for p in prompts]
    finally:
        eng.stop()
    counts = _delta(before)
    assert not {n: c for n, c in counts.items() if n in PLAINS}, counts
    bf16 = dtype == torch.bfloat16
    fwd, other = ("flash_fwd", "flash_fwd_tf32x3")[::1 if bf16 else -1]
    assert counts.get(fwd, 0) > 0, counts
    assert counts.get("paged_attention" if bf16 else "paged_attention_f32", 0) > 0, counts
    # bf16 (D256 included) never reaches the fp32 forward, fp32 only it
    assert not counts.get(other, 0), counts
    assert not counts.get("flash_fwd_lse_tf32x3", 0), counts
    assert all(len(t) == 6 for t in got)
    if dtype == torch.float32:
        cpu = LLMEngine(cfg, params, device="cpu", num_slots=2, max_seq_len=128, page_size=16,
                        prefill_buckets=[64])
        try:
            want = [cpu.generate(p, max_tokens=6, timeout=120)["tokens"] for p in prompts]
        finally:
            cpu.stop()
        assert got == want


# --------------------------------------------- the cluster runtime on the card
@pytest.fixture(scope="module")
def gpu_cluster():
    """One node of the port's cluster (GCS, agent, worker processes) whose
    agent counts the card itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cluster's GPU workers run on it")
    import ray_tpu_torch
    from ray_tpu_torch.cluster import Cluster

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    c = Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
    try:
        ray_tpu_torch.init(address=c.gcs_address)
        yield c
    finally:
        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        c.shutdown()


def test_cluster_gpu_task_sees_one_card(gpu_cluster):
    """A num_gpus=1 task's process sees one card and computes on it; a CPU
    task's process sees none."""
    import ray_tpu_torch

    assert ray_tpu_torch.cluster_resources()["GPU"] == torch.cuda.device_count()

    @ray_tpu_torch.remote(num_gpus=1)
    def gpu():
        import os

        import torch

        x = torch.ones(4, device="cuda")
        return os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.device_count(), \
            x.device.type, float(x.sum())

    @ray_tpu_torch.remote
    def cpu():
        import os

        import torch

        return os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.is_available()

    assert ray_tpu_torch.get(gpu.remote(), timeout=120) == ("0", 1, "cuda", 4.0)
    assert ray_tpu_torch.get(cpu.remote(), timeout=120) == ("", False)


def test_cluster_cuda_tensor_roundtrip(gpu_cluster):
    """A bf16 CUDA tensor put by the driver reaches a GPU task's process on
    its card and comes back on the driver's card, bit-equal."""
    import ray_tpu_torch

    x = torch.randn(1 << 20, device="cuda").to(torch.bfloat16)

    @ray_tpu_torch.remote(num_gpus=1)
    def echo(t):
        return t.device.type, t * 1

    where, back = ray_tpu_torch.get(echo.remote(ray_tpu_torch.put(x)), timeout=120)
    assert where == "cuda" and back.device.type == "cuda" and back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))


def test_cluster_gpu_actor_launches_k1(gpu_cluster):
    """A num_gpus=1 actor (a worker process of its own) runs the prefill
    attention through K1: one launch in its own counts, and the output
    within the bf16 tolerance of the plain version."""
    import ray_tpu_torch

    @ray_tpu_torch.remote(num_gpus=1)
    class Attn:
        def run(self):
            import torch

            from ray_tpu_torch import _kernels
            from ray_tpu_torch.ops import attention as ta

            g = torch.Generator(device="cuda").manual_seed(7)
            q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
                       for s in ((2, 256, 16, 128), (2, 256, 4, 128), (2, 256, 4, 128)))
            before = _kernels.launch_counts["flash_fwd"]
            out = ta.flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
            launches = _kernels.launch_counts["flash_fwd"] - before
            ref = ta.reference_attention(q, k, v, causal=True)
            bad = ((out.float() - ref.float()).abs()
                   > 1e-2 + 1.6e-2 * ref.float().abs()).sum().item()
            return launches, bad, bool(torch.isfinite(out).all())

    a = Attn.remote()
    try:
        assert ray_tpu_torch.get(a.run.remote(), timeout=300) == (1, 0, True)
    finally:
        ray_tpu_torch.kill(a)
