"""The comparison that decides ``correct``: the numbers read from what the
timed path produced against the plain reference, each held to its limit
(``perfbench/limits/<cell>.json``).

Training, over the first three steps of the timed step from one state.
Every gradient is the first step's as the optimizer got it, worked out
from the velocity after that step (g = -v / lr - wd p); every change is the
parameters' over the three steps. Per leaf, each reading is over
max(the reference's norm of that leaf, the median leaf's):

  * ``loss1_gap``: the first step's |loss - reference's| / |reference's|
    (the forward's precision, before the steps part); ``loss_gap``: the
    largest over the three steps;
  * ``grad_gap``: the worst leaf's gap between the norms of the
    program's gradient and the reference's, |program's - reference's|;
    ``grad_median_gap``: the median leaf's;
  * ``change_gap``: the same of the change;
  * ``grad_diff``: the worst leaf's norm of the difference of the two
    gradients, ||program's - reference's||; ``grad_median_diff``: the
    median leaf's; ``head_grad_diff``: the worst of the head's leaves
    (``head/``), the only ones whose gradient passes no ReLU's derivative.
  * ``bn_median_var_gap``: over the batch norm layers, the median of
    ||first batch variance - reference's|| / ||reference's||. The
    program's running statistics after its first update are its batch's.

Rounding that cancels in a gap of norms does not in a norm of the
difference. And a ReLU's derivative is a step: rounding by u flips the
mask of a share of about u of its inputs, each carrying its whole
gradient, so every gradient below a ReLU differs by about sqrt(u) and a
precision 16 times coarser reads only some 3 times as far off. The head's
gradient is a smooth function of the forward, off by about u, and the
batch statistics are means over millions of values: they part one
precision from the next, and the statistics a full batch from half of it.

Leaves whose reference gradient is under a thousandth of the median leaf's
move by round-off alone and count in none of them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

NEGLIGIBLE_GRADIENT = 1e-3
HEAD = "head/"


def _norms(tree: Dict[str, np.ndarray]) -> Dict[str, float]:
    return {k: float(np.linalg.norm(v.astype(np.float64))) for k, v in tree.items()}


def gradient(velocity: Dict[str, np.ndarray], params0: Dict[str, np.ndarray],
             hp: Dict) -> Dict[str, np.ndarray]:
    """The first step's gradient as the optimizer got it, from the
    velocity after that step: v = -lr (g + wd p) (wd on 4-D kernels)."""
    out = {}
    for k, v in velocity.items():
        decay = hp["weight_decay"] * params0[k] if params0[k].ndim == 4 else 0.0
        out[k] = -v.astype(np.float64) / hp["learning_rate"] - decay
    return out


def leaf_readings(mine: Dict, ref: Dict, params0: Dict[str, np.ndarray],
                  hp: Dict) -> Dict[str, Dict[str, float]]:
    """{leaf: {"grad_gap", "change_gap", "grad_diff"}} of every leaf that
    counts (see the module's docstring), from two sides' records
    (``reference.train.steps``)."""
    grad, ref_grad = (gradient(side["velocity1"], params0, hp) for side in (mine, ref))
    change, ref_change = ({k: side["params3"][k] - v for k, v in params0.items()}
                          for side in (mine, ref))
    ref_g, ref_c = _norms(ref_grad), _norms(ref_change)
    median_g = float(np.median(list(ref_g.values())))
    keep = [k for k, n in ref_g.items() if n >= NEGLIGIBLE_GRADIENT * median_g]
    floor_g = float(np.median([ref_g[k] for k in keep]))
    floor_c = float(np.median([ref_c[k] for k in keep]))
    out = {}
    for k in keep:
        g = grad[k].astype(np.float64)
        out[k] = {
            "grad_gap": float(abs(np.linalg.norm(g) - ref_g[k]) / max(ref_g[k], floor_g)),
            "change_gap": float(abs(np.linalg.norm(change[k].astype(np.float64)) - ref_c[k])
                                / max(ref_c[k], floor_c)),
            "grad_diff": float(np.linalg.norm(g - ref_grad[k])) / max(ref_g[k], floor_g),
        }
    return out


def bn_readings(mine: Dict, ref: Dict) -> Dict[str, float]:
    """{batch norm layer: ||first batch variance - reference's|| /
    ||reference's||}."""
    a, b = mine["stats1"], ref["stats1"]
    return {key[:-len("/var")]: float(np.linalg.norm(a[key] - b[key].astype(np.float64))
                                      / np.linalg.norm(b[key].astype(np.float64)))
            for key in b if key.endswith("/var")}


def train_numbers(mine: Dict, ref: Dict, params0: Dict[str, np.ndarray],
                  hp: Dict) -> Dict[str, float]:
    losses, ref_losses = mine["losses"], ref["losses"]
    leaves = leaf_readings(mine, ref, params0, hp)
    out = {
        "loss1_gap": abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
    }
    for key in ("grad_gap", "change_gap", "grad_diff"):
        out[key] = max(leaf[key] for leaf in leaves.values())
    for key in ("grad_gap", "grad_diff"):
        out[key.replace("_", "_median_", 1)] = float(np.median(
            [leaf[key] for leaf in leaves.values()]))
    out["head_grad_diff"] = max(v["grad_diff"] for k, v in leaves.items()
                                if k.startswith(HEAD))
    out["bn_median_var_gap"] = float(np.median(list(bn_readings(mine, ref).values())))
    return out


def held(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """{name: {"value", "limit"}} of every number with a limit; a number
    without a reading (None) fails its limit."""
    out = {}
    for name, limit in limits.items():
        value: Optional[float] = numbers.get(name)
        out[name] = {"value": value, "limit": limit}
    return out


def passed(checks: Dict[str, Dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
