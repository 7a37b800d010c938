"""Percentiles: the yardstick's own arithmetic.

``percentile`` is the arithmetic of ``repro_torch.serve.scheduler._pct``
(numpy's linear interpolation), copied so that a change to the program
cannot move it, except that an empty sample gives None, not 0: a metric
with nothing to read is left out of the result line.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def percentile(xs: Sequence[float], q: float) -> Optional[float]:
    if len(xs) == 0:
        return None
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))

