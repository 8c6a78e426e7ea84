"""Phase timers: per-phase wall time summed over a step.

The port's own copy of ``rlinf_tpu/utils/timers.py``. ``scope(name,
block_on=tree)`` waits for the CUDA devices of ``tree``'s tensors before
it reads the clock (``utils/sync.synchronize``): without that wait a
phase's time would be its dispatch, not its work.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

from rlinf_tpu_torch.utils.sync import synchronize


class Timers:
    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str, block_on=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                synchronize(block_on)
            dt = time.perf_counter() - start
            self._totals[name] += dt
            self._counts[name] += 1

    def record(self, name: str, seconds: float):
        self._totals[name] += seconds
        self._counts[name] += 1

    def consume(self, reduction: str = "sum") -> Dict[str, float]:
        """Pop the accumulated durations: their sum, or their mean with
        ``reduction="mean"``."""
        if reduction == "mean":
            out = {
                k: self._totals[k] / max(self._counts[k], 1) for k in self._totals
            }
        else:
            out = dict(self._totals)
        self._totals.clear()
        self._counts.clear()
        return out
