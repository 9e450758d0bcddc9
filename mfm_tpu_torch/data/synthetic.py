"""Seeded synthetic panels (numpy only).

:func:`synthetic_risk_inputs` is a copy of the JAX package's
``__graft_entry__._synthetic_risk_inputs`` (which imports JAX, so the port
cannot use it): the same numpy draws in the same order, so a seed gives
both packages the same panel.
"""

from __future__ import annotations

import numpy as np

#: the CSI300 universe of the reference's config-1 workload (T, N, P, Q)
CSI300 = (1390, 300, 31, 10)


def synthetic_risk_inputs(T: int, N: int, P: int, Q: int, seed: int = 0):
    """(ret, cap, styles, industry, valid) numpy arrays: float32 (T, N),
    (T, N), (T, N, Q), int32 industry codes (T, N) and a bool (T, N)
    universe in which every industry keeps one stock on every date."""
    rng = np.random.default_rng(seed)
    industry = rng.integers(0, P, size=N)
    styles = rng.standard_normal((T, N, Q)).astype(np.float32)
    ret = (0.01 * rng.standard_normal((T, N))).astype(np.float32)
    cap = np.exp(rng.normal(11.0, 1.0, size=(1, N))).astype(np.float32)
    cap = np.broadcast_to(cap, (T, N)).copy()
    valid = rng.random((T, N)) > 0.03
    # keep every industry populated each date (the constraint matrix needs
    # the last industry's cap)
    first = np.array([np.argmax(industry == p) for p in range(P)])
    valid[:, first] = True
    return (ret, cap, styles,
            np.broadcast_to(industry, (T, N)).astype(np.int32), valid)
