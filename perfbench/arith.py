"""The yardstick's arithmetic, frozen here so a change to the program cannot
move it: the card's peaks, the model FLOPs a token, and each kernel's
operations and bytes, all from shapes and lengths alone.

- ``train_flops_per_token`` is ``ray_tpu_torch/bench.py``'s MFU count,
  ``6 N + 6 L H S`` (N every parameter, embedding included).
- ``serve_flops`` counts a served token as ``2 N`` (every parameter but the
  embedding table, which is a lookup) plus attention over the context it
  sees: the causal triangle of the prompt in prefill, the whole cache in
  decode (4 x heads x head_dim a visible pair: scores and values).
- The kernel counts copy PERF.md's bound arithmetic (the port's table of
  kernels): each input read once, each output written once, the visible half
  of causal products. K1' writes the lse; K2 reads q, k, v, o, dO, lse and
  delta and writes dQ; K3 writes dK and dV.
"""

from __future__ import annotations

from typing import Iterable, Tuple

# One NVIDIA H100 SXM (data sheet, dense, at the 700 W limit).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    """Least time the card could take: operations or bytes at peak, the larger."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def num_params(m) -> int:
    """Every parameter (``m``: perfbench.reference.llama.Dims), untied head."""
    attn = m.hidden * m.heads * m.head_dim * 2 + m.hidden * m.kv_heads * m.head_dim * 2
    per_layer = attn + 3 * m.hidden * m.inter + 2 * m.hidden
    return m.layers * per_layer + 2 * m.vocab * m.hidden + m.hidden


def train_flops_per_token(m, seq: int) -> float:
    """``bench.py``'s count: 6 N + 6 L H S."""
    return 6.0 * num_params(m) + 6.0 * m.layers * m.hidden * seq


def matmul_params(m) -> int:
    """Parameters a served token multiplies by: all but the embedding table."""
    return num_params(m) - m.vocab * m.hidden


def attn_pair_flops(m) -> float:
    """Attention FLOPs of one visible (query, key) pair, all layers."""
    return 4.0 * m.layers * m.heads * m.head_dim


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def prefill_flops(m, prompt_lengths: Iterable[int]) -> float:
    """Model FLOPs of prefilling these prompts (unpadded)."""
    total = 0.0
    for n in prompt_lengths:
        total += 2.0 * matmul_params(m) * n + attn_pair_flops(m) * causal_pairs(n)
    return total


def decode_flops(m, contexts: Iterable[int]) -> float:
    """Model FLOPs of decode tokens, each attending over ``context`` rows."""
    total = 0.0
    for c in contexts:
        total += 2.0 * matmul_params(m) + attn_pair_flops(m) * c
    return total


def k4_work(m, rows: Iterable[int]) -> Tuple[float, float]:
    """(flops, bytes) of one layer's paged-attention call over slots that
    need ``rows`` cached rows each: q in, out back, K and V rows read once."""
    rows = list(rows)
    total = sum(rows)
    flops = 4.0 * m.heads * m.head_dim * total
    nbytes = BF16 * (2 * len(rows) * m.heads * m.head_dim + 2 * total * m.kv_heads * m.head_dim)
    return flops, nbytes


def k1_work(m, lengths: Iterable[int]) -> Tuple[float, float]:
    """(flops, bytes) of one layer's causal prefill attention over prompts
    of these (unpadded) lengths: q, k, v read once, out written once."""
    flops = nbytes = 0.0
    for n in lengths:
        flops += 4.0 * m.heads * m.head_dim * causal_pairs(n)
        nbytes += BF16 * (2 * n * m.heads * m.head_dim + 2 * n * m.kv_heads * m.head_dim)
    return flops, nbytes


def flash_train_work(m, batch: int, seq: int) -> dict:
    """{kernel: (flops, bytes)} of one layer's K1' (forward with lse), K2
    (dQ) and K3 (dK, dV) over a causal [batch, seq] step."""
    pairs = batch * causal_pairs(seq)
    q_el = batch * seq * m.heads * m.head_dim
    kv_el = batch * seq * m.kv_heads * m.head_dim
    rows = batch * m.heads * seq
    hd = m.heads * m.head_dim
    return {
        "k1l": (4.0 * hd * pairs, BF16 * (3 * q_el + 2 * kv_el) + 4.0 * rows),
        "k2": (6.0 * hd * pairs, BF16 * (3 * q_el + 2 * kv_el) + 8.0 * rows),
        "k3": (8.0 * hd * pairs, BF16 * (2 * q_el + 4 * kv_el) + 8.0 * rows),
    }
