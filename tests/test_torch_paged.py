"""Port parity, KV-cached decode: ray_tpu_torch.models.{decode,paged_decode}
against ray_tpu's on the CPU, fp32, tiny config, same converted weights.

Tolerances are the JAX package's own: logits atol 1e-4
(tests/test_model_llama.py), attention atol 2e-5 (tests/test_ops_attention.py),
greedy tokens equal (tests/test_paged_decode.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode as jd
from ray_tpu.models import paged_decode as jpd
from ray_tpu.models.llama import LlamaConfig as JConfig
from ray_tpu.models.llama import llama_init as j_llama_init
from ray_tpu_torch.models import decode as td
from ray_tpu_torch.models import paged_decode as tpd
from ray_tpu_torch.models.llama import LlamaConfig as TConfig
from ray_tpu_torch.models.llama import params_from_jax

PS = 16       # page size
BUCKET = 32   # prefill bucket (multiple of PS)
T = 6         # decode chunk


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig.tiny(dtype=jnp.float32, remat=None, attention_impl="reference")
    tcfg = TConfig.tiny(dtype=torch.float32)
    jparams = j_llama_init(jcfg, jax.random.key(0))
    return jcfg, jparams, tcfg, params_from_jax(jparams)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# --------------------------------------------------------------------------- #
# Attention and scatters
# --------------------------------------------------------------------------- #
def _paged_inputs(seed, b=5, nh=4, nkv=2, d=32, ps=8, max_pages=4, total=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, nh, d)).astype(np.float32)
    kp = rng.standard_normal((nkv, total, ps, d)).astype(np.float32)
    vp = rng.standard_normal((nkv, total, ps, d)).astype(np.float32)
    lengths = rng.integers(1, max_pages * ps + 1, (b,)).astype(np.int32)
    lengths[0] = 1  # an inactive slot: all-trash table row
    perm = rng.permutation(np.arange(1, total))
    table = np.zeros((b, max_pages), np.int32)
    for s in range(1, b):
        n = -(-int(lengths[s]) // ps)
        table[s, :n] = perm[(s * max_pages) % (total - 1 - max_pages):][:n]
    return q, kp, vp, table, lengths


def _paged_case(lengths, ps, max_pages, retired=(), seed=0, nh=4, nkv=1, d=32):
    """Each slot's own random pages in a pool of 1 + B * max_pages pages;
    ``retired`` slots keep an all-zero table row (every row in trash page 0)."""
    rng = np.random.default_rng(seed)
    b, total = len(lengths), 1 + len(lengths) * max_pages
    q = rng.standard_normal((b, nh, d)).astype(np.float32)
    kp = rng.standard_normal((nkv, total, ps, d)).astype(np.float32)
    vp = rng.standard_normal((nkv, total, ps, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, total))
    table = np.zeros((b, max_pages), np.int32)
    for s, n_rows in enumerate(lengths):
        if s not in retired:
            n = -(-n_rows // ps)
            table[s, :n] = perm[s * max_pages:][:n]
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _edge_lengths(ps, max_pages):
    """Lengths at the edges of the CUDA kernel's 128-row chunks, of 64-row
    pages and of the table."""
    full = max_pages * ps
    return sorted({min(n, full) for n in (1, 63, 64, 65, 127, 128, 129, 256)} | {full})


@pytest.mark.parametrize("case", [
    *[pytest.param(seed, id=str(seed)) for seed in (0, 1, 2)],
    *[pytest.param(dict(lengths=_edge_lengths(ps, mp), ps=ps, max_pages=mp, seed=ps + mp),
                   id=f"edges-ps{ps}-pages{mp}")
      for ps, mp in [(16, 32), (64, 32), (16, 8), (64, 3), (48, 10)]],
    # a retired slot: an all-zero table row with length 300 reads trash page 0
    # five times over
    pytest.param(dict(lengths=[300, 700, 300, 5], ps=64, max_pages=32, retired=(0, 2), seed=3),
                 id="retired-slot"),
    pytest.param(dict(lengths=np.random.default_rng(11).integers(1537, 2049, 4).tolist(), ps=64,
                      max_pages=32, seed=11), id="long-context"),
])
def test_paged_attention_reference_matches_jax(case):
    q, kp, vp, table, lengths = (_paged_inputs(case) if isinstance(case, int)
                                 else _paged_case(**case))
    want = np.asarray(jpd._paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), 0.3))
    got = tpd._paged_attention_reference(_t(q), _t(kp), _t(vp), _t(table), _t(lengths), 0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    # the kernel wrapper takes the plain version for CPU tensors (q pre-scaled)
    got = tpd.paged_attention(_t(q) * 0.3, _t(kp), _t(vp), _t(table), _t(lengths))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,nkv,max_pages,ps,sms,want", [
    (64, 4, 32, 64, 132, 1),    # the serving engine at llama_1b: 256 (slot, kv head) pairs
    (4, 4, 32, 64, 132, 9),     # few slots, long table: split until the grid fills the card
    (1, 4, 32, 64, 132, 16),    # one slot: as many splits as the table has chunks
    (3, 1, 1, 64, 132, 1),      # a table shorter than one chunk
])
def test_split_count(b, nkv, max_pages, ps, sms, want):
    got = tpd.split_count(b, nkv, max_pages, ps, sms)
    assert got == want
    chunks = -(-max_pages * ps // tpd.CHUNK)
    assert 1 <= got <= chunks
    assert got == chunks or b * nkv * got >= sms


@pytest.mark.parametrize("ps,ok", [(8, True), (16, True), (24, True), (48, True), (64, True),
                                   (96, True), (192, True), (0, False), (4, False),
                                   (12, False), (30, False)])
def test_check_page_size(ps, ok):
    """The decode kernel takes pages of whole TMA boxes of 8..128 rows."""
    if ok:
        tpd.check_page_size(ps)
    else:
        with pytest.raises(ValueError, match="multiple of 8"):
            tpd.check_page_size(ps)


@pytest.mark.parametrize("d,tiles", [(128, True), (256, True), (32, False), (64, False),
                                     (96, False)])
def test_paged_dispatch_rule(d, tiles):
    """The JAX package's rule: head dims off multiples of 128 take the plain
    version; the others go to the kernel wrapper, which raises on what it
    does not take."""
    assert tpd.kernel_tiles(d) is tiles


@pytest.mark.parametrize("d,nh,nkv,dtype,match", [
    (128, 16, 4, torch.bfloat16, None),            # llama_1b
    (128, 32, 8, torch.bfloat16, None),            # llama3_8b
    (128, 16, 8, torch.bfloat16, "nh/n_kv 4"),     # group 2
    (128, 28, 4, torch.bfloat16, "nh/n_kv 4"),     # group 7
    (256, 16, 4, torch.bfloat16, "D 128"),
    (128, 16, 4, torch.float32, "bfloat16"),
])
def test_check_layer(d, nh, nkv, dtype, match):
    if match is None:
        tpd.check_layer(d, nh, nkv, dtype)
    else:
        with pytest.raises(ValueError, match=match):
            tpd.check_layer(d, nh, nkv, dtype)


def test_engine_checks_the_page_size_only_where_the_kernel_runs():
    """A page size the decode kernel cannot load is refused only for a shape
    the kernel takes: tiny on the CPU runs the plain version at any size."""
    from ray_tpu_torch.serve.llm import LLMEngine

    eng = LLMEngine(TConfig.tiny(dtype=torch.float32), device="cpu", num_slots=1,
                    max_seq_len=48, page_size=12, prefill_buckets=[24])
    try:
        assert len(eng.generate([3, 1, 4, 1, 5], max_tokens=4, timeout=60)["tokens"]) == 4
    finally:
        eng.stop()


def test_paged_attention_layer_wrapper_matches_jax(models):
    jcfg, _, tcfg, _ = models
    q, kp, vp, table, lengths = _paged_inputs(3)
    q4 = q[:, None]  # [B, 1, nh, D]
    want = np.asarray(jpd._paged_attention(
        jnp.asarray(q4), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), 32 ** -0.5, jcfg))
    got = tpd._paged_attention(_t(q4), _t(kp), _t(vp), _t(table), _t(lengths), 32 ** -0.5, tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_scatter_token_rows_matches_jax():
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((2, 9, 8, 16)).astype(np.float32)
    rows = rng.standard_normal((4, 2, 16)).astype(np.float32)
    pages = np.array([3, 0, 7, 0], np.int32)  # two inactive slots -> trash page 0
    rownum = np.array([5, 2, 0, 2], np.int32)
    want = np.asarray(jpd._scatter_token_rows(jnp.asarray(pool), jnp.asarray(rows),
                                              jnp.asarray(pages), jnp.asarray(rownum)))
    tpool = _t(pool)
    out = tpd._scatter_token_rows(tpool, _t(rows), _t(pages), _t(rownum))
    assert out.data_ptr() == tpool.data_ptr()  # in place, where JAX donates
    # page 0 takes duplicate writes (undefined winner in both); compare the rest
    np.testing.assert_array_equal(tpool.numpy()[:, 1:], want[:, 1:])


def test_scatter_prompt_rows_full_matches_jax():
    rng = np.random.default_rng(5)
    cache = rng.standard_normal((3, 2, 10, 4, 8)).astype(np.float32)  # [L, nkv, P, ps, D]
    rows = rng.standard_normal((3, 8, 2, 8)).astype(np.float32)       # [PB, S=2*ps, nkv, D]
    pages = np.array([[4, 2], [9, 1], [0, 0]], np.int32)              # last row: padding
    want = np.asarray(jpd._scatter_prompt_rows_full(
        jnp.asarray(cache), jnp.asarray(rows), 1, jnp.asarray(pages), 4))
    tcache = _t(cache)
    tpd._scatter_prompt_rows_full(tcache, _t(rows), 1, _t(pages), 4)
    np.testing.assert_array_equal(tcache.numpy()[:, :, 1:], want[:, :, 1:])


# --------------------------------------------------------------------------- #
# Prefill + decode against JAX
# --------------------------------------------------------------------------- #
def _prompts(seed, lens, vocab):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def test_paged_prefill_and_decode_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    lens = [13, 27]
    prompts = _prompts(7, lens, jcfg.vocab_size)
    tokens = np.zeros((2, BUCKET), np.int32)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = p
    pages = np.array([[1, 2], [3, 4]], np.int32)
    table = np.zeros((3, 4), np.int32)  # slot 2 inactive: trash row
    table[0, :3] = [1, 2, 5]
    table[1, :3] = [3, 4, 6]
    jcache = jpd.init_paged_cache(jcfg, 9, PS, dtype=jnp.float32)
    tcache = tpd.init_paged_cache(tcfg, 9, PS, dtype=torch.float32, device="cpu")
    with jax.default_matmul_precision("highest"):
        jl, jcache = jpd.paged_prefill(jparams, jcache, jnp.asarray(tokens), jnp.asarray(pages),
                                       jnp.asarray(lens, jnp.int32), jcfg, PS)
    tl, tcache = tpd.paged_prefill(tparams, tcache, _t(tokens), _t(pages),
                                   _t(lens, torch.int32), tcfg, PS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tcache.k.numpy()[:, :, 1:], np.asarray(jcache.k)[:, :, 1:],
                               atol=1e-5)
    # teacher-forced ticks: logits per tick
    rng = np.random.default_rng(8)
    pos = np.array(lens + [0], np.int32)
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab_size, 3).astype(np.int32)
        with jax.default_matmul_precision("highest"):
            jlog, jcache = jpd.paged_decode_one(jparams, jcache, jnp.asarray(toks),
                                                jnp.asarray(pos), jnp.asarray(table), jcfg, PS)
        tlog, tcache = tpd.paged_decode_one(tparams, tcache, _t(toks), _t(pos), _t(table),
                                            tcfg, PS)
        np.testing.assert_allclose(tlog.numpy()[:2], np.asarray(jlog)[:2], atol=1e-4)
        pos[:2] += 1
    # greedy multi-step decode: tokens equal
    first = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    toks = np.array([first[0], first[1], 0], np.int32)
    act = np.array([True, True, False])
    with jax.default_matmul_precision("highest"):
        js, jlast, jpos, _ = jpd.paged_decode_steps(
            jparams, jcache, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(act),
            jnp.asarray(table), jax.random.key(1), jcfg, T, PS)
    ts, tlast, tpos, _ = tpd.paged_decode_steps(
        tparams, tcache, _t(toks), _t(pos), _t(act), _t(table), None, tcfg, T, PS)
    assert ts.shape == (3, T)
    np.testing.assert_array_equal(ts.numpy()[:2], np.asarray(js)[:2])
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))


def test_dense_prefill_and_decode_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    (prompt,) = _prompts(9, [11], jcfg.vocab_size)
    padded = np.zeros((1, BUCKET), np.int32)
    padded[0, :11] = prompt
    jcache = jd.init_kv_cache(jcfg, 2, 64, dtype=jnp.float32)
    tcache = td.init_kv_cache(tcfg, 2, 64, dtype=torch.float32, device="cpu")
    with jax.default_matmul_precision("highest"):
        jl, jcache = jd.prefill(jparams, jcache, jnp.asarray(padded), jnp.int32(1),
                                jnp.int32(11), jcfg)
    tl, tcache = td.prefill(tparams, tcache, _t(padded), 1, 11, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), atol=1e-5)
    pos = np.array([0, 11], np.int32)
    toks = np.array([0, int(np.argmax(np.asarray(jl)))], np.int32)
    with jax.default_matmul_precision("highest"):
        jlog, _ = jd.decode_one(jparams, jcache, jnp.asarray(toks), jnp.asarray(pos), jcfg)
    tlog, _ = td.decode_one(tparams, td.KVCache(tcache.k.clone(), tcache.v.clone()), _t(toks),
                            _t(pos), tcfg)
    np.testing.assert_allclose(tlog.numpy()[1], np.asarray(jlog)[1], atol=1e-4)
    act = np.array([False, True])
    with jax.default_matmul_precision("highest"):
        js, _, jpos, _ = jd.decode_steps(jparams, jcache, jnp.asarray(toks), jnp.asarray(pos),
                                         jnp.asarray(act), jax.random.key(1), jcfg, T)
    ts, _, tpos, _ = td.decode_steps(tparams, tcache, _t(toks), _t(pos), _t(act), None, tcfg, T)
    np.testing.assert_array_equal(ts.numpy()[1], np.asarray(js)[1])
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


def test_dense_decode_clamps_positions_past_the_cache(models):
    """A slot that finished mid-chunk ticks past max_seq: JAX's
    dynamic_update_slice pins the write to the last row; the port clamps."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(10)
    k0 = rng.standard_normal((2, 2, 16, 2, 32)).astype(np.float32)
    jcache = jd.KVCache(jnp.asarray(k0), jnp.asarray(k0))
    tcache = td.KVCache(_t(k0), _t(k0))
    toks, pos = np.array([5, 6], np.int32), np.array([3, 40], np.int32)
    with jax.default_matmul_precision("highest"):
        jlog, jcache = jd.decode_one(jparams, jcache, jnp.asarray(toks), jnp.asarray(pos), jcfg)
    tlog, tcache = td.decode_one(tparams, tcache, _t(toks), _t(pos), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=1e-5)


# --------------------------------------------------------------------------- #
# tests/test_paged_decode.py's cases, the port's paged path against JAX dense
# --------------------------------------------------------------------------- #
def _jax_dense_generate(jcfg, jparams, prompt, steps):
    cache = jd.init_kv_cache(jcfg, 2, 64, dtype=jnp.float32)
    padded = np.zeros((1, BUCKET), np.int32)
    padded[0, :len(prompt)] = prompt
    logits, cache = jd.prefill(jparams, cache, jnp.asarray(padded), jnp.int32(0),
                               jnp.int32(len(prompt)), jcfg)
    first = int(jnp.argmax(logits))
    dec = jd.make_decode_fn(jcfg, steps, 0.0)
    toks = jnp.zeros((2,), jnp.int32).at[0].set(first)
    pos = jnp.zeros((2,), jnp.int32).at[0].set(len(prompt))
    act = jnp.zeros((2,), bool).at[0].set(True)
    sampled, *_ = dec(jparams, cache, toks, pos, act, jax.random.key(1))
    return [first] + [int(t) for t in sampled[0]]


def _torch_paged_generate(tcfg, tparams, prompt, steps, num_slots=2, total_pages=9):
    cache = tpd.init_paged_cache(tcfg, total_pages, PS, dtype=torch.float32, device="cpu")
    alloc = tpd.PageAllocator(total_pages)
    pages = alloc.alloc(4)
    assert tpd.PageAllocator.TRASH_PAGE not in pages
    padded = np.zeros((1, BUCKET), np.int32)
    padded[0, :len(prompt)] = prompt
    logits, cache = tpd.paged_prefill(
        tparams, cache, _t(padded), torch.tensor([pages[: BUCKET // PS]], dtype=torch.int32),
        torch.tensor([len(prompt)], dtype=torch.int32), tcfg, PS)
    first = int(torch.argmax(logits[0]))
    table = torch.zeros((num_slots, 4), dtype=torch.int32)  # zeros = trash page
    table[0, : len(pages)] = torch.tensor(pages)
    dec = tpd.make_paged_decode_fn(tcfg, steps, PS, 0.0)
    toks = torch.zeros((num_slots,), dtype=torch.int32)
    toks[0] = first
    pos = torch.zeros((num_slots,), dtype=torch.int32)
    pos[0] = len(prompt)
    act = torch.zeros((num_slots,), dtype=torch.bool)
    act[0] = True
    sampled, *_ = dec(tparams, cache, toks, pos, act, table, None)
    return [first] + [int(t) for t in sampled[0]]


@pytest.mark.parametrize("seed,plen,steps,slots", [
    (0, 13, T, 2),    # paged matches dense greedy
    (1, 13, 24, 2),   # crosses the 16-row page boundary, then into page 2
    (2, 9, T, 7),     # six inactive slots never corrupt the live pages
])
def test_torch_paged_matches_jax_dense(models, seed, plen, steps, slots):
    jcfg, jparams, tcfg, tparams = models
    prompt = list(np.random.default_rng(seed).integers(0, jcfg.vocab_size, plen))
    with jax.default_matmul_precision("highest"):
        want = _jax_dense_generate(jcfg, jparams, prompt, steps)
    got = _torch_paged_generate(tcfg, tparams, prompt, steps, num_slots=slots)
    assert got == want, (got, want)


def test_page_allocator_reserves_trash_and_recycles():
    a = tpd.PageAllocator(8)
    assert a.free_pages == 7
    got = a.alloc(7)
    assert 0 not in got
    assert a.alloc(1) is None
    a.release(got[:3])
    assert a.free_pages == 3
    again = a.alloc(3)
    assert set(again) == set(got[:3])
    with pytest.raises(ValueError, match="trash"):
        a.release([0])


def test_page_allocator_hands_out_pages_in_jax_order():
    j, t = jpd.PageAllocator(12), tpd.PageAllocator(12)
    assert j.alloc(5) == t.alloc(5)
    j.release([3, 1])
    t.release([3, 1])
    assert j.alloc(4) == t.alloc(4)


def test_sample_token_temperature_uses_generator():
    logits = torch.randn(4, 50)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tpd.sample_token(logits, g1, 0.8)
    b = tpd.sample_token(logits, g2, 0.8)
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert torch.equal(tpd.sample_token(logits, None, 0.0), logits.argmax(-1).to(torch.int32))
