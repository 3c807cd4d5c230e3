"""The comparisons that decide ``correct``, against the plain reference
(``perfbench/reference/llama.py``); the limits are each cell's, in
``perfbench/limits/<cell>.json``, with the readings they were set from.

Serving: the served tokens are greedy, so each should be the reference's
best at its position, up to rounding. The number compared is the widest gap,
over the sampled requests, by which a served token's reference logit lies
below the reference's best logit at that position (0 where they agree).

Training: each of the first steps' losses, the first gradient as the update
takes it, and each leaf's change after the steps, the last two by the worst
leaf (per layer for stacked weights): the gap between the program's norm and
the reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger. Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import torch

from perfbench.reference import llama as ref

GRAD_FLOOR = 1e-3


def _positions(prompt, served) -> Tuple[torch.Tensor, int]:
    seq = list(map(int, prompt)) + list(map(int, served[:-1]))
    return torch.tensor(seq, dtype=torch.long), len(prompt) - 1


def served_gap(d, params, seqs: Sequence[Tuple[Sequence[int], Sequence[int]]],
               first_by: str = "served") -> float:
    """Widest gap over (prompt, served tokens) pairs. ``first_by="fp8"``
    reads, at the same positions, the gap of the token that the reference in
    float8 puts first: the control. Nothing to compare reads infinite."""
    widest = 0.0 if any(len(s) for _, s in seqs) else float("inf")
    for prompt, served in seqs:
        if not len(served):
            continue
        tokens, start = _positions(prompt, served)
        exact = ref.logits(d, params, tokens)[start:start + len(served)]
        if first_by == "served":
            chosen = torch.tensor(list(map(int, served)), device=exact.device)
        else:
            chosen = ref.logits(d, params, tokens, first_by)[start:start + len(served)].argmax(-1)
        gap = exact.max(-1).values - exact.gather(-1, chosen[:, None].long())[:, 0]
        widest = max(widest, float(gap.max()))
    return widest


def leaf_norms(tree) -> Dict[str, float]:
    """{leaf: norm} of a nested dict of tensors, stacked layers split per layer."""
    out = {}
    for name, t in ref.leaves(tree).items():
        out.update(ref._leaf_norms(name, t.detach()))
    return out


def norm_gap(prog: Dict[str, float], refn: Dict[str, float], counted: List[str]) -> Tuple[float, str]:
    """Worst |prog - ref| over max(ref, median ref) among ``counted`` leaves."""
    med = statistics.median(refn[k] for k in counted)
    worst, at = 0.0, ""
    for k in counted:
        g = abs(prog[k] - refn[k]) / max(refn[k], med)
        if g > worst:
            worst, at = g, k
    return worst, at


def train_numbers(prog: dict, refr: dict) -> dict:
    """prog and refr: {"losses": [...], "first_grad": {leaf: norm},
    "change": {leaf: norm}}. Returns the numbers compared and where the
    worst leaf lies."""
    med = statistics.median(refr["first_grad"].values())
    counted = [k for k, v in refr["first_grad"].items() if v >= GRAD_FLOOR * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], refr["losses"]))
    grad_gap, grad_at = norm_gap(prog["first_grad"], refr["first_grad"], counted)
    change_gap, change_at = norm_gap(prog["change"], refr["change"], counted)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_worst_leaf": grad_at, "change_worst_leaf": change_at,
            "leaves_left_out": len(refr["first_grad"]) - len(counted)}
