"""The comparisons that decide `correct`, each a number held against the
cell's limit (`limits/<workload>.json`).

Training: each checked step's loss (`loss_gap`, the widest absolute
gap); each leaf's first gradient as the optimizer gets it (`grad_gap`)
and its change over the checked steps (`change_gap`), each by the worst
leaf: the gap between the program's norm and the reference's, over the
larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of `change_gap`.

Serving: the widest gap by which a served token's reference logit lies
below the reference's best at its position (`logit_gap`).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

#: Gradients under this share of the median leaf's are round-off.
ROUNDOFF_SHARE = 1e-3


def worst_leaf(prog: Dict[str, float], refs: Dict[str, float],
               leaves=None) -> Tuple[float, str]:
    leaves = list(refs) if leaves is None else list(leaves)
    median = statistics.median(refs[n] for n in refs)
    worst, where = 0.0, ""
    for n in leaves:
        gap = abs(prog[n] - refs[n]) / max(refs[n], median, 1e-30)
        if not gap <= worst:  # a NaN is the worst
            worst, where = (gap if gap == gap else float("inf")), n
    return worst, where


def moved_leaves(raw_grad: Dict[str, float]) -> List[str]:
    median = statistics.median(raw_grad.values())
    return [n for n, g in raw_grad.items() if g >= ROUNDOFF_SHARE * median]


def train_numbers(prog: dict, ref: dict, steps: int) -> Dict[str, float]:
    """The compared numbers of a program run (or a stand-in) against the
    reference over the reference's `steps` steps. `prog` has `losses`,
    `first_grad` and `change` (after the same steps)."""
    loss_gap = max((abs(x - y) if abs(x - y) == abs(x - y) else float("inf"))
                   for x, y in zip(prog["losses"][:steps], ref["losses"][:steps]))
    grad_gap, grad_leaf = worst_leaf(prog["first_grad"], ref["first_grad"])
    moved = moved_leaves(ref["raw_grad"])
    change_gap, change_leaf = worst_leaf(prog["change"], ref["change"], moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": change_gap, "grad_leaf": grad_leaf,
            "change_leaf": change_leaf,
            "roundoff_leaves": len(ref["raw_grad"]) - len(moved)}


def logit_gaps(ref_logits, tokens) -> List[float]:
    """Per served position: the reference's best logit less the served
    token's. `ref_logits` [n, vocab] f32, `tokens` [n]."""
    import torch

    tokens = torch.as_tensor(tokens, device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens[:, None])[:, 0]
    return (best - got).tolist()


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> List[Tuple[str, float, float]]:
    """(name, number, limit) of every limited number."""
    return [(name, float(numbers[name]), float(limit))
            for name, limit in limits.items()]


def within(checked) -> bool:
    return all(value <= limit for _, value, limit in checked)
