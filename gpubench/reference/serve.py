"""The plain reference of the serving cell: one full forward of each
checked request's prompt and served tokens (teacher forcing, no cache),
from the benchmark's weights for the seed, a layer at a time.

`served_logits` gives, at every served position, the reference's
logits for that position's token; `gap_readings` turns them into the
served tokens' gaps and, for a control precision, the gap of the token
that the control puts first.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .. import weights
from . import compare
from . import model as ref


@torch.no_grad()
def served_logits(a: dict, seed: int, requests: Sequence[tuple], device,
                  precisions=("f32",)) -> Dict[str, List[torch.Tensor]]:
    """`requests`: (prompt ids, served ids). For each precision, a list
    of [len(served), vocab] f32 logits: row i predicts served token i."""
    seqs = [torch.tensor(list(p) + list(s[:-1]), device=device)
            for p, s in requests]
    glob = weights.global_weights(a, seed, device)
    xs = {prec: [glob["embed"][s][None].float() for s in seqs]
          for prec in precisions}
    tables = [ref.rope_tables(len(s), a["head_dim"], a["rope_theta"], device)
              for s in seqs]
    for i in range(a["layers"]):
        w = {k: t.float() for k, t in weights.layer_weights(a, seed, i, device).items()}
        for prec in precisions:
            mm = ref.PRECISIONS[prec]
            xs[prec] = [ref.layer(x, w, cos, sin, a, mm)
                        for x, (cos, sin) in zip(xs[prec], tables)]
        del w
    fn, hw = glob["final_norm"].float(), glob["head"].float()
    out = {}
    for prec in precisions:
        mm = ref.PRECISIONS[prec]
        out[prec] = [ref.head(x[0, len(p) - 1:], fn, hw, a, mm)
                     for x, (p, _) in zip(xs[prec], requests)]
    return out


def gap_readings(logits: Dict[str, List[torch.Tensor]], requests) -> dict:
    """`logit_gap`: the widest gap of a served token under the f32
    reference; `<precision>_gap` for each other precision: the widest
    gap of the token that precision puts first."""
    out = {"logit_gap": max(max(compare.logit_gaps(lg, s))
                            for lg, (_, s) in zip(logits["f32"], requests)),
           "served_tokens": sum(len(s) for _, s in requests)}
    for prec, rows in logits.items():
        if prec != "f32":
            out[f"{prec}_gap"] = max(
                max(compare.logit_gaps(f, r.argmax(-1)))
                for f, r in zip(logits["f32"], rows))
    return out
