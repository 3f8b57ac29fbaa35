"""LSH detection-probability theory (paper §6.3, Figure 6).

The port's own copy of ``repro.core.theory`` (numpy only): the S-curve of
detection probability against Jaccard similarity for t tables of k hash
functions with an m-of-t match threshold.
"""
from __future__ import annotations

import math

import numpy as np


def detection_probability(s, k: int, m: int, t: int = 100):
    """P[pair with Jaccard s matches in ≥ m of t tables of k hash fns].

    P[s] = 1 - Σ_{i<m} C(t, i) (s^k)^i (1 - s^k)^{t-i}
    """
    s = np.asarray(s, np.float64)
    p = s**k
    acc = np.zeros_like(s)
    for i in range(m):
        acc += math.comb(t, i) * p**i * (1 - p) ** (t - i)
    return 1.0 - acc


def s_curve_threshold(k: int, m: int, t: int = 100,
                      level: float = 0.5) -> float:
    """Jaccard similarity at which detection probability crosses ``level``."""
    lo, hi = 0.0, 1.0
    for _ in range(60):
        mid = (lo + hi) / 2
        if detection_probability(mid, k, m, t) < level:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def equivalent_m(k_old: int, m_old: int, k_new: int, t: int = 100) -> int:
    """Smallest m_new keeping the S-curve midpoint ≤ the old one (§6.3).

    This is the paper's 'increase hash functions, lower the match
    threshold, same detection probability' parameter move.
    """
    target = s_curve_threshold(k_old, m_old, t)
    for m_new in range(1, t + 1):
        if s_curve_threshold(k_new, m_new, t) >= target:
            return max(1, m_new - 1) if m_new > 1 else 1
    return t
