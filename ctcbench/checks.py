"""The numbers that decide ``correct``, each held against its limit from
the configuration file's ``limits``.

Training: each step's loss against the reference's (relative gap, the
worst step); the first gradient as the optimizer takes it and the
parameters' change after the checked steps, each by the worst leaf: the
gap between the program's norm of the leaf and the reference's, over the
larger of the reference's norm of that leaf and of the median leaf.
Leaves whose first reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the change.  On a
mesh, the ranks' parameters must be bit-equal.

Decoding: the widest gap between the program's log posteriors and the
reference's on live frames, and the share of utterances whose hypothesis
from the program's decode differs from the float32 reference search's on
the program's own posteriors (an exact comparison): the search stage
followed from the program's state, whose start, the posteriors, is the
first number's.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np

# a loss that is not finite reads so
UNREADABLE = 1e9
DEAD_LEAF = 1e-3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> float:
    keys = [k for k in ref if keep is None or k in keep]
    median = statistics.median(ref[k] for k in ref)
    worst = 0.0
    for k in keys:
        base = max(ref[k], median)
        if base > 0:
            worst = max(worst, abs(prog[k] - ref[k]) / base)
    return worst


def live_leaves(grad: Dict[str, float]) -> List[str]:
    median = statistics.median(grad.values())
    return [k for k, v in grad.items() if v >= DEAD_LEAF * median]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """{loss_rel, grad_leaf, update_leaf} of the program's readings
    against the reference's (``reference.train.run_steps``)."""
    n = len(ref["losses"])
    loss = max(abs(p - r) / max(abs(r), 1e-30) if np.isfinite(p)
               else UNREADABLE
               for p, r in zip(prog["losses"][:n], ref["losses"]))
    return {"loss_rel": float(loss),
            "grad_leaf": _leaf_gap(prog["grad"], ref["grad"]),
            "update_leaf": _leaf_gap(prog["change"], ref["change"],
                                     keep=set(live_leaves(ref["grad"])))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Dict[str, dict]:
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in numbers.items()}


def is_correct(checks: Dict[str, dict]) -> bool:
    return all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())

