"""Percentiles of request times, with failures counted above any limit."""

from __future__ import annotations

import math
from typing import Iterable, Optional

#: the value a percentile takes when it falls on a failed request, in the
#: metric's own unit: above any limit a run could set
FAILED = 1e12


def percentile(values: Iterable[Optional[float]], q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100). ``None`` marks a
    request that failed, was shed or was refused: it ranks above every
    time, and a percentile that lands on one reads :data:`FAILED`."""
    xs = sorted(math.inf if v is None else float(v) for v in values)
    if not xs:
        raise ValueError("no values")
    x = xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]
    return FAILED if math.isinf(x) else x
