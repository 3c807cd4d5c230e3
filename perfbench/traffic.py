"""The one traffic generator: requests and arrivals from a mix's parameters
(``traffic`` in ``perfbench/workloads/<cell>.json``) and ``--seed``.

Every seed gets the same set of sizes and gaps in another order: a length or
a gap is drawn as the quantile of its distribution at (i + 0.5) / block for
i < block, and each block of ``block`` requests is a fresh permutation of
those values. So any whole number of blocks holds exactly the same work, and
seeds differ in order and in token ids, not in how much there is to do.

A distribution is ``{"kind": "log_uniform" | "uniform", "min": a, "max": b}``
(integers, ``max`` included). Arrivals are ``{"kind": "poisson", "rate": r}``
(exponential gaps, mean 1 / r seconds) or absent (a closed loop: each client
sends when its last request ends). ``first_round: n`` makes the first n
requests (a closed loop's first request of each of its n clients) requests
caught in flight at a random moment of the steady state: an output length
drawn in proportion to itself, of which a uniform share is still to come,
and the part already produced appended to the prompt (as token ids drawn
like the prompt's), so the request's context is as long as it would be in
flight. The loop then starts in its steady state instead of with every
client at the start of a request at once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    prompt: np.ndarray  # int32 token ids
    max_tokens: int
    due: Optional[float] = None  # seconds after the first send (open loop)


def quantile(dist: dict, u: np.ndarray) -> np.ndarray:
    kind = dist["kind"]
    if kind == "uniform":
        return dist["min"] + u * (dist["max"] + 1 - dist["min"])
    if kind == "log_uniform":
        lo, hi = math.log(dist["min"]), math.log(dist["max"] + 1)
        return np.exp(lo + u * (hi - lo))
    if kind == "exponential":
        return -np.log1p(-u) / dist["rate"]
    raise ValueError(f"unknown distribution kind {kind!r}")


def blocked(dist: dict, n: int, block: int, rng: np.random.Generator) -> np.ndarray:
    """n values: each block of ``block`` a permutation of the same quantiles."""
    base = quantile(dist, (np.arange(block) + 0.5) / block)
    out = [base[rng.permutation(block)] for _ in range(-(-n // block))]
    return np.concatenate(out)[:n]


def lengths(dist: dict, n: int, block: int, rng) -> np.ndarray:
    vals = np.floor(blocked(dist, n, block, rng)).astype(np.int64)
    return np.clip(vals, dist["min"], dist["max"])


def in_flight(dist: dict, n: int, block: int, rng: np.random.Generator):
    """Output lengths of n requests caught in flight (see above): the tokens
    each still has to produce (at least 1) and the tokens it has produced;
    every seed gets the same pairs in another order."""
    base = np.sort(lengths(dist, block, block, rng))
    cum = np.cumsum(base) / base.sum()
    u = (np.arange(n) + 0.5) / n
    biased = base[np.minimum(np.searchsorted(cum, u), block - 1)]
    share = u[np.random.default_rng(0).permutation(n)]  # the same pairs for every seed
    remaining = np.maximum(1, np.ceil(share * biased)).astype(np.int64)
    order = rng.permutation(n)
    return remaining[order], (biased - remaining)[order]


def make(traffic: dict, vocab: int, seed: int) -> List[Request]:
    """The cell's requests in sending order. Keys: ``requests`` (how many),
    ``block``, ``prompt`` and ``output`` (distributions of prompt and output
    lengths), optional ``arrivals``."""
    rng = np.random.default_rng([seed, 1])
    n, block = traffic["requests"], traffic["block"]
    prompts = lengths(traffic["prompt"], n, block, rng)
    outputs = lengths(traffic["output"], n, block, rng)
    first = traffic.get("first_round", 0)
    if first:
        outputs[:first], produced = in_flight(traffic["output"], first, block, rng)
        prompts[:first] += produced
    due = None
    arrivals = traffic.get("arrivals")
    if arrivals is not None:
        if arrivals["kind"] != "poisson":
            raise ValueError(f"unknown arrivals kind {arrivals['kind']!r}")
        gaps = blocked({"kind": "exponential", "rate": arrivals["rate"]}, n, block, rng)
        due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    ids = rng.integers(0, vocab, int(prompts.sum()), dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(prompts)])
    return [Request(index=i, prompt=ids[starts[i]:starts[i + 1]], max_tokens=int(outputs[i]),
                    due=None if due is None else float(due[i]))
            for i in range(n)]


def train_batch(seed: int, step: int, batch: int, seq: int, vocab: int, device):
    """Step ``step``'s rows: token ids uniform over the vocabulary, drawn on
    the device from (seed, step), and targets = tokens shifted left by one
    (the last wraps round)."""
    import torch

    sub = int(np.random.SeedSequence([seed, 2, step]).generate_state(1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device).manual_seed(sub)
    tokens = torch.randint(0, vocab, (batch, seq), generator=gen, device=device)
    return tokens, torch.roll(tokens, -1, dims=1)
