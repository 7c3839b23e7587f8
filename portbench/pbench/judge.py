"""The numbers that decide ``correct``, each against a reference.

Training: each checked step's loss, the norm of step 1's gradient as
AdamW got it, and the norm of each leaf's change over the checked steps,
the last two by the worst leaf: the gap between the program's norm and
the reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger.  Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out
of the change.

Serving: the gap by which each served token's logit lies below the
reference's largest logit at its position: the widest, the mean, and the
share of served tokens that are not the reference's first choice.

Each reading is computed in every run; a cell's limits file names the
ones it compares (``check``), and the others are printed beside them.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

FLAT_GRADIENT = 1e-3


def leaf_gaps(a: Dict[str, float], r: Dict[str, float],
              keys) -> Dict[str, float]:
    """{leaf: the gap between the program's norm ``a`` and the reference's
    ``r``, over the reference's norm of that leaf or of the median leaf,
    whichever is larger}."""
    keys = list(keys)
    if set(keys) - set(a):
        missing = sorted(set(keys) - set(a))[:5]
        raise KeyError(f"the program has no reading of leaves {missing}")
    med = statistics.median(r[k] for k in keys)
    return {k: abs(a[k] - r[k]) / max(r[k], med) for k in keys}


def train_readings(losses, g1, change, ref_losses, ref_g1, ref_change) -> dict:
    """The training readings: the worst step's loss (``loss_rel``) and the
    first step's (``loss1_rel``), each relative to the reference's; the
    worst leaf's gap of the step-1 gradient's norm (``grad_norm_rel``) and
    of the change's norm over the checked steps (``change_norm_rel``),
    each also at the median leaf (``*_med``)."""
    if len(losses) != len(ref_losses):
        raise ValueError(f"{len(losses)} losses against {len(ref_losses)}")
    med = statistics.median(ref_g1.values())
    moving = [k for k, v in ref_g1.items() if v >= FLAT_GRADIENT * med]
    grad = leaf_gaps(g1, ref_g1, ref_g1)
    chg = leaf_gaps(change, ref_change, moving)
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    return {
        "loss_rel": max(loss),
        "loss1_rel": loss[0],
        "grad_norm_rel": max(grad.values()),
        "grad_norm_med": statistics.median(grad.values()),
        "change_norm_rel": max(chg.values()),
        "change_norm_med": statistics.median(chg.values()),
    }


def worst_leaves(g1, change, ref_g1, ref_change, n: int = 3) -> dict:
    """The ``n`` leaves with the widest gaps of each norm, for a look at
    what a reading is made of."""
    med = statistics.median(ref_g1.values())
    moving = [k for k, v in ref_g1.items() if v >= FLAT_GRADIENT * med]
    out = {}
    for name, gaps in (("grad", leaf_gaps(g1, ref_g1, ref_g1)),
                       ("change", leaf_gaps(change, ref_change, moving))):
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
        out[name] = [[k, v] for k, v in top]
    return out


def serve_readings(gaps_: List[float]) -> dict:
    """The serving readings over the gaps of every checked token."""
    if not gaps_:
        return {"gap_max": math.inf, "gap_mean": math.inf,
                "miss_share": math.inf}
    return {"gap_max": max(gaps_),
            "gap_mean": sum(gaps_) / len(gaps_),
            "miss_share": sum(g > 0 for g in gaps_) / len(gaps_)}


def gaps(logits, tokens: List[int]) -> List[float]:
    """Each position's gap: its largest logit less the given token's.
    logits (n, V) on any device, tokens n ids."""
    import torch
    idx = torch.as_tensor(tokens, device=logits.device, dtype=torch.long)
    best = logits.max(-1).values
    return (best - logits.gather(-1, idx[:, None])[:, 0]).tolist()


def check(readings: dict, limits: dict) -> List[tuple]:
    """[(name, value, limit)] of every number that ``limits`` names; a
    number over its limit (or not a number) fails."""
    missing = sorted(set(limits) - set(readings))
    if missing:
        raise KeyError(f"no reading of {missing}")
    return [(name, readings[name], lim) for name, lim in limits.items()]


def passed(checks: List[tuple]) -> bool:
    return all(v == v and v <= lim for _, v, lim in checks)
