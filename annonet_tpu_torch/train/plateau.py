"""Loss-plateau detection: steps-without-decrease statistics (a verbatim
copy of ``annonet_tpu/train/plateau.py``: numpy and scipy).

The reference relies on dlib's dnn_trainer plateau heuristic behind
NetPimpl::SetIterationsWithoutProgressThreshold
(annonet_train_main.cpp:388,408): the trainer keeps recent loss values,
counts the longest suffix over which it is NOT confident the loss is
decreasing (a running linear-regression slope test), and shrinks the
learning rate when both the plain and outlier-robust counts exceed the
threshold. The dlib submodule is empty in the snapshot (SURVEY.md caveat),
so this reimplements the documented algorithm from its public semantics:

  count_steps_without_decrease(series, p):
      scan the series from most recent backwards, incrementally fitting a
      line; the count is the largest window size for which
      P(slope_of_reversed_series > 0) < p — i.e. we are not >=p confident
      the forward series is decreasing.

Unlike a per-step incremental scan, this implementation is fully vectorized
over all window sizes with prefix sums (O(n) NumPy, no Python loop), which
matters because the train loop calls it every step with windows of several
thousand losses.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy.special import ndtr  # standard normal CDF, vectorized


def _prob_slope_positive(y_rev: np.ndarray) -> np.ndarray:
    """For every window size m (prefix of the reversed series), the
    probability that the regression slope is > 0, via the t-statistic of an
    ordinary least-squares fit under a normal approximation.

    Returns an array p[m-1] for m = 1..n; entries for m <= 2 are 0.5
    (no evidence either way).
    """
    n = y_rev.size
    x = np.arange(n, dtype=np.float64)
    m = np.arange(1, n + 1, dtype=np.float64)

    cx = np.cumsum(x)
    cy = np.cumsum(y_rev)
    cxx = np.cumsum(x * x)
    cyy = np.cumsum(y_rev * y_rev)
    cxy = np.cumsum(x * y_rev)

    sxx = cxx - cx * cx / m
    syy = cyy - cy * cy / m
    sxy = cxy - cx * cy / m

    with np.errstate(divide="ignore", invalid="ignore"):
        slope = sxy / sxx
        ss_res = np.maximum(syy - slope * sxy, 0.0)
        var = ss_res / np.maximum(m - 2, 1.0)
        se = np.sqrt(var / sxx)
        t = slope / se

    # windows of size <= 2 carry no evidence; perfect fits give +-inf t
    t = np.where(m <= 2, 0.0, t)
    t = np.nan_to_num(t, nan=0.0, posinf=np.inf, neginf=-np.inf)
    return ndtr(t)


def count_steps_without_decrease(
    losses: Sequence[float], probability_of_decrease: float = 0.51
) -> int:
    """Longest recent window over which the loss is not confidently decreasing.

    Scanning the series in reverse, a positive regression slope means the
    forward series is decreasing; the count is the largest window size whose
    P(slope > 0) falls below ``probability_of_decrease``.
    """
    y = np.asarray(losses, dtype=np.float64)
    if y.size == 0:
        return 0
    p = _prob_slope_positive(y[::-1])
    m = np.arange(1, y.size + 1)
    qualifying = m[(m > 2) & (p < probability_of_decrease)]
    return int(qualifying.max()) if qualifying.size else 0


def count_steps_without_decrease_robust(
    losses: Sequence[float],
    probability_of_decrease: float = 0.51,
    quantile_discard: float = 0.10,
) -> int:
    """Outlier-robust variant: losses above the (1 - quantile_discard)
    quantile are dropped (order preserved) before counting, so occasional
    loss spikes don't mask a plateau."""
    y = np.asarray(losses, dtype=np.float64)
    if y.size == 0:
        return 0
    threshold = np.quantile(y, 1.0 - quantile_discard)
    kept = y[y <= threshold]
    return count_steps_without_decrease(kept, probability_of_decrease)
