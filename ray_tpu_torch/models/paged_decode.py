"""Paged KV cache + paged decode for the serving engine.

Port of ray_tpu/models/paged_decode.py. The KV cache is a PAGE POOL
[L, n_kv, total_pages, page_size, D]; each slot owns a list of pages
recorded in a block table [num_slots, max_pages_per_slot]. Memory is
committed per request (ceil((prompt+max_tokens)/page_size) pages), not per
slot * max_seq.

Decode attention runs the hand-written CUDA kernels ``csrc/paged_attention.cu``
through ``paged_attention``: they read exactly the pages a slot owns, in place
in the pool, each slot's sequence split over several blocks whose partial
softmaxes a second kernel merges. On a CPU tensor the wrapper runs
``_paged_attention_reference``, the gather-based plain version. On the card,
``_paged_attention`` sends a layer of a head dim the kernel does not tile
(``kernel_tiles``: the JAX package's rule, ``head_dim % 128 != 0``) to the
plain version and counts it as ``paged_attention_plain``, as the JAX package
takes its gather path there. A head dim it tiles at a GQA group or dtype the
kernel does not take raises in the wrapper.

The pool is updated in place where the JAX version donates it through
``jit``. PAGE 0 IS THE TRASH PAGE: inactive slots and padded prefill rows
keep table rows of zeros, so their writes land in page 0, which no live
slot ever reads. Those writes use duplicate indices, whose result is
undefined; that is harmless only because page 0 is never read.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ray_tpu_torch import _kernels
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.decode import _lm_head, _mlp, _project_qkv, sample_token
from ray_tpu_torch.models.llama import LlamaConfig, layer_params
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.rope import apply_rope, rope_frequencies

KERNEL = "paged_attention"
PLAIN = "paged_attention_plain"
# What the kernel takes: bf16, one head dim, one GQA group. The dispatch rule
# sends only head dims off multiples of TILE to the plain version.
HEAD_DIM, GROUP, TILE = 128, 4, 128


class PagedKVCache(NamedTuple):
    k: torch.Tensor  # [L, n_kv, total_pages, page_size, D]
    v: torch.Tensor  # [L, n_kv, total_pages, page_size, D]


def init_paged_cache(config: LlamaConfig, total_pages: int, page_size: int,
                     dtype=torch.bfloat16, device=None) -> PagedKVCache:
    dev = resolve_device(device)
    shape = (config.num_layers, config.num_kv_heads, total_pages, page_size,
             config.head_dim_)
    return PagedKVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                        v=torch.zeros(shape, dtype=dtype, device=dev))


def _scatter_token_rows(pool, rows, pages, rownum):
    """pool: [n_kv, P_total, ps, D]; rows: [B, n_kv, D]; pages/rownum: [B].
    One decoded token per slot -> written in place at (page, row)."""
    pool[:, pages.long(), rownum.long()] = rows.transpose(0, 1).to(pool.dtype)
    return pool


def _paged_attention_reference(q, k_pool, v_pool, table, lengths, scale):
    """Gather-based paged attention (the plain version).
    q: [B, nh, D]; pools: [n_kv, P_total, ps, D]; table: [B, max_pages];
    lengths: [B] (inclusive count of valid rows)."""
    b, nh, d = q.shape
    nkv, _, ps, _ = k_pool.shape
    max_pages = table.shape[1]
    t = table.long()
    kg = k_pool[:, t].transpose(0, 1).reshape(b, nkv, max_pages * ps, d)
    vg = v_pool[:, t].transpose(0, 1).reshape(b, nkv, max_pages * ps, d)
    qg = q.reshape(b, nkv, nh // nkv, d)
    logits = torch.einsum("bnrd,bnsd->bnrs", qg.float(), kg.float()) * scale
    mask = torch.arange(max_pages * ps, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(mask[:, None, None, :], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnrs,bnsd->bnrd", probs.to(vg.dtype).float(), vg.float())
    return out.reshape(b, nh, d).to(q.dtype)


# A block of the split kernel loads CHUNK rows of a slot at once; the
# library's ``paged_attention_chunk_rows`` is checked against it when it loads.
# A slot is split only when its (slot, kv head) blocks alone would leave SMs
# idle: every split beyond one costs a merge launch.
CHUNK = 128
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])


def split_count(b: int, nkv: int, max_pages: int, page_size: int, sms: int) -> int:
    """Blocks per (slot, kv head) of the split kernel: enough for the grid to
    give each of ``sms`` SMs one block, never more than the table's CHUNK-row
    chunks. Block z of a slot takes chunks z, z + splits, ..."""
    chunks = -(-max_pages * page_size // CHUNK)
    want = -(-sms // max(1, b * nkv))
    return max(1, min(chunks, want))


def check_layer(head_dim: int, num_heads: int, num_kv_heads: int, dtype) -> None:
    """Raise unless the kernel takes a layer of this shape and dtype: bf16,
    head_dim 128, 4 q heads per kv head."""
    if head_dim != HEAD_DIM or num_heads % num_kv_heads or num_heads // num_kv_heads != GROUP:
        raise ValueError(f"paged_attention kernel takes D {HEAD_DIM} and nh/n_kv {GROUP}; "
                         f"got D={head_dim}, nh={num_heads}, n_kv={num_kv_heads}")
    if dtype != torch.bfloat16:
        raise ValueError(f"paged_attention kernel takes bfloat16, got {dtype}")


def check_page_size(page_size: int) -> None:
    """Raise unless the kernel can load a page as whole TMA boxes of 8 to 128
    rows: a multiple of 8."""
    if page_size <= 0 or page_size % 8:
        raise ValueError(f"paged_attention kernel takes a page size that is a multiple of 8; "
                         f"got {page_size}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry():
    """The library and its C entry point, argument types set once."""
    lib = _kernels.library(KERNEL)
    rows = lib.paged_attention_chunk_rows()
    if rows != CHUNK:
        raise RuntimeError(f"{KERNEL} library loads {rows} rows a chunk, split_count {CHUNK}")
    fn = lib.paged_attention_bf16
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def paged_attention(q, k_pool, v_pool, table, lengths):
    """Kernel wrapper. q: [B, nh, D], already scaled; pools: [n_kv, P_total,
    ps, D] (one layer); table: [B, max_pages] int32; lengths: [B] int32.
    Launches the CUDA kernels for CUDA tensors (bf16, D 128, nh/n_kv 4: the
    shape of every config on the serving path; page size a multiple of 8)
    and raises on anything else; runs the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return _paged_attention_reference(q, k_pool, v_pool, table, lengths, 1.0)
    b, nh, d = q.shape
    nkv, total_pages, ps, _ = k_pool.shape
    max_pages = table.shape[1]
    check_layer(d, nh, nkv, q.dtype)
    check_page_size(ps)
    if v_pool.shape != k_pool.shape or k_pool.shape[3] != d:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not fit q")
    if table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"table {tuple(table.shape)} / lengths {tuple(lengths.shape)} "
                         f"do not fit {b} slots")
    dev = q.device
    for name, t, dt in (("q", q, torch.bfloat16), ("k_pool", k_pool, torch.bfloat16),
                        ("v_pool", v_pool, torch.bfloat16), ("table", table, torch.int32),
                        ("lengths", lengths, torch.int32)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    splits = split_count(b, nkv, max_pages, ps, _sm_count(dev.index))
    out = torch.empty_like(q)
    partials = (torch.empty(b * nh * splits * (d + 2), dtype=torch.float32, device=dev)
                if splits > 1 else None)
    lib, fn = _entry()
    err = fn(_kernels.ptr(q), _kernels.ptr(k_pool), _kernels.ptr(v_pool), _kernels.ptr(table),
             _kernels.ptr(lengths), _kernels.ptr(out), b, nh, nkv, d, total_pages, ps,
             max_pages, None if partials is None else _kernels.ptr(partials), splits,
             _kernels.stream_of(q))
    _kernels.check(lib, err, KERNEL)
    _kernels.launch_counts[KERNEL] += 1
    return out


def kernel_tiles(head_dim: int) -> bool:
    """The dispatch rule of ``_paged_attention`` on the card: whether the
    decode kernel tiles this head dim, by the JAX package's rule. Group,
    dtype and page size are no part of the rule: the wrapper raises on those
    it does not take."""
    return head_dim % TILE == 0


def _paged_attention(q, k_pool, v_pool, table, lengths, scale, config):
    """q: [B, 1, nh, D] -> [B, 1, nh, D]. q is scaled here: the kernel does
    not scale it."""
    qs = (q[:, 0] * scale).to(q.dtype)
    if q.device.type == "cuda" and not kernel_tiles(q.shape[-1]):
        _kernels.launch_counts[PLAIN] += 1
        return _paged_attention_reference(qs, k_pool, v_pool, table, lengths, 1.0)[:, None]
    return paged_attention(qs, k_pool, v_pool, table, lengths)[:, None]


# --------------------------------------------------------------------------- #
# Prefill
# --------------------------------------------------------------------------- #
def _scatter_prompt_rows_full(cache_full, rows, layer: int, pages, page_size: int):
    """cache_full: [L, n_kv, P_total, ps, D]; rows: [PB, S, n_kv, D]
    (S = NP*ps); pages: [PB, NP]. Writes every prompt's K/V pages in place."""
    pb, s, nkv, d = rows.shape
    np_ = s // page_size
    vals = rows.reshape(pb * np_, page_size, nkv, d).permute(2, 0, 1, 3)  # [nkv, N, ps, D]
    cache_full[layer][:, pages.reshape(-1).long()] = vals.to(cache_full.dtype)
    return cache_full


@torch.inference_mode()
def paged_prefill(params, cache: PagedKVCache, tokens, pages, lengths,
                  config: LlamaConfig, page_size: int) -> Tuple[torch.Tensor, PagedKVCache]:
    """BATCHED prefill: tokens [PB, S_bucket] (padded, S_bucket %
    page_size == 0); pages [PB, S_bucket // page_size] page ids per prompt;
    lengths [PB] true prompt lengths. Returns (last-token logits [PB, V],
    cache updated in place)."""
    pb, s = tokens.shape
    cos, sin = rope_frequencies(config.head_dim_, s, config.rope_theta, device=tokens.device)
    x = params["embed_tokens"][tokens].to(config.dtype)
    for layer in range(config.num_layers):
        lp = layer_params(params, layer)
        _, q, k, v = _project_qkv(config, lp, x)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = attention(q, k, v, causal=True, impl=config.attention_impl)
        b, t, nh, hd = q.shape
        x = x + o.reshape(b, t, nh * hd) @ lp["wo"]
        x = x + _mlp(config, lp, x)
        _scatter_prompt_rows_full(cache.k, k, layer, pages, page_size)
        _scatter_prompt_rows_full(cache.v, v, layer, pages, page_size)
    # the head runs only on each prompt's last row (rms_norm and the head
    # matmul are per row): the full [PB, S, V] fp32 logits are never built
    last = (lengths.long() - 1).clamp(0, s - 1)
    x_last = x[torch.arange(pb, device=x.device), last]  # [PB, H]
    return _lm_head(params, x_last, config), cache


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
@torch.inference_mode()
def paged_decode_one(params, cache: PagedKVCache, tokens, positions, table,
                     config: LlamaConfig, page_size: int) -> Tuple[torch.Tensor, PagedKVCache]:
    """One decode tick. tokens/positions: [B]; table: [B, max_pages] int32.
    positions[b] = cache index the current token writes to; attention spans
    [0, positions[b]] inclusive."""
    scale = config.head_dim_ ** -0.5
    max_ctx = table.shape[1] * page_size
    cos, sin = rope_frequencies(config.head_dim_, max_ctx, config.rope_theta,
                                device=tokens.device)
    x = params["embed_tokens"][tokens[:, None]].to(config.dtype)  # [B, 1, H]
    # clamp: a slot finishing mid-chunk keeps ticking to the chunk end (the
    # host truncates its output later); its position may overrun the table,
    # so pin it to the last row, as the JAX version does (apply_rope clamps
    # the rope lookup the same way)
    safe_pos = positions.clamp(max=max_ctx - 1)
    pages = torch.gather(table, 1, (safe_pos // page_size).long()[:, None])[:, 0]
    rows = safe_pos % page_size
    lengths = (safe_pos + 1).to(torch.int32)
    for layer in range(config.num_layers):
        lp = layer_params(params, layer)
        _, q, k, v = _project_qkv(config, lp, x)
        q = apply_rope(q, cos, sin, positions=positions[:, None])
        k = apply_rope(k, cos, sin, positions=positions[:, None])
        ck, cv = cache.k[layer], cache.v[layer]
        _scatter_token_rows(ck, k[:, 0], pages, rows)
        _scatter_token_rows(cv, v[:, 0], pages, rows)
        o = _paged_attention(q, ck, cv, table, lengths, scale, config)
        b, t, nh, hd = q.shape
        x = x + o.reshape(b, t, nh * hd) @ lp["wo"]
        x = x + _mlp(config, lp, x)
    return _lm_head(params, x, config)[:, 0], cache


@torch.inference_mode()
def paged_decode_steps(params, cache: PagedKVCache, tokens, positions, active,
                       table, generator: Optional[torch.Generator],
                       config: LlamaConfig, num_steps: int, page_size: int,
                       temperature: float = 0.0):
    """T decode ticks (like decode.decode_steps, paged). The host
    pre-provisions table pages covering positions+T before each chunk."""
    toks, pos = tokens, positions
    out = []
    for _ in range(num_steps):
        logits, cache = paged_decode_one(params, cache, toks, pos, table, config, page_size)
        nxt = sample_token(logits, generator, temperature)
        toks = torch.where(active, nxt, toks)
        pos = torch.where(active, pos + 1, pos)
        out.append(toks)
    return torch.stack(out, dim=1), toks, pos, cache


def make_paged_decode_fn(config: LlamaConfig, num_steps: int, page_size: int,
                         temperature: float = 0.0):
    return functools.partial(paged_decode_steps, config=config, num_steps=num_steps,
                             page_size=page_size, temperature=temperature)


def make_paged_prefill_fn(config: LlamaConfig, page_size: int):
    return functools.partial(paged_prefill, config=config, page_size=page_size)


class PageAllocator:
    """Host-side free-list of KV pages (the vLLM block-manager analogue).
    Worst-case commitment at admission: a request takes
    ceil((prompt+max_tokens)/page_size) pages up front, so decode can never
    run out of pages mid-flight.

    PAGE 0 IS THE TRASH PAGE and is never handed out: inactive slots keep
    block-table rows of zeros, so their frozen-position writes land in page
    0 instead of in a live slot's pages."""

    TRASH_PAGE = 0

    def __init__(self, total_pages: int):
        self.total = total_pages
        self._free = list(range(total_pages - 1, 0, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[list]:
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def release(self, pages) -> None:
        if self.TRASH_PAGE in pages:
            raise ValueError("the trash page is never allocated and cannot be released")
        self._free.extend(pages)
