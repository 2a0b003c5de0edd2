"""The numbers that decide ``correct``, worked out from the program's
readings and the reference's, and their comparison with the cell's
limits (``limits/<cell>.json``, each limit with the readings it was set
from)."""
from __future__ import annotations

import statistics
from typing import Dict, List, Mapping, Tuple

# A leaf whose reference gradient is under this share of the median
# leaf's moves under AdamW by round-off alone: it is left out of the
# change (a key bias under softmax is such a leaf).
DEAD_LEAF = 1e-3


def _worst_leaf(prog: Mapping[str, float], ref: Mapping[str, float],
                keys: List[str]) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``loss``: the largest relative gap of a step's loss; ``grad1``: the
    first gradient's worst leaf; ``change``: the parameters' change after
    the steps, worst leaf, over the leaves the reference's first gradient
    moves."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"],
                                                     ref["loss"]))
    keys = sorted(ref["grad1"])
    med_g = statistics.median(ref["grad1"][k] for k in keys)
    live = [k for k in keys if ref["grad1"][k] >= DEAD_LEAF * med_g]
    return {"loss": loss,
            "grad1": _worst_leaf(prog["grad1"], ref["grad1"], keys),
            "change": _worst_leaf(prog["change"], ref["change"], live)}


def serve_numbers(gaps: List[List[float]]) -> Dict[str, float]:
    """The gap by which a served token's logit lies below the reference's
    best at its position, over the standard deviation of that position's
    logits: ``logit_gap_mean`` over the served tokens checked, and
    ``logit_gap_max``, the widest. A few tokens whose MoE routing sits on
    a near tie flip in bfloat16 and read a wide gap in a sound run as in
    the fp8 control, so the widest does not tell the two apart; the mean
    does (``limits/<cell>.json`` says which is compared)."""
    flat = [g for row in gaps for g in row]
    return {"logit_gap_mean": sum(flat) / len(flat),
            "logit_gap_max": max(flat)}


def verdict(numbers: Dict[str, float], limits: Dict
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Every number at or under its limit -> (correct, {name: {"value",
    "limit"}}). A number that is missing or not finite fails."""
    checks = {}
    ok = True
    for name, spec in limits["numbers"].items():
        v = numbers.get(name, float("nan"))
        lim = float(spec["limit"])
        checks[name] = {"value": v, "limit": lim}
        if not v <= lim:
            ok = False
    return ok, checks
