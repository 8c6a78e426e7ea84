"""Priority-ordered trajectory store for async RL.

The port's own copy of ``rlinf_tpu/data/priority_store.py``.

Reference analog: rlinf/data/priority_store.py — trajectories keyed by a
(min_version, mean_version) priority tuple; a bounded store that evicts the
lowest-priority (oldest among ties) item, serves the freshest top-n for
training, and tracks how many trajectories were discarded without ever
being used (the async-RL staleness diagnostic). sortedcontainers is
replaced by bisect over a plain list.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, List, Tuple

import numpy as np


class PriorityStore:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._seq = 0
        self._items: List[Tuple[Tuple, int, Any]] = []  # sorted by (prio, seq)
        self._keys: List[Tuple] = []                    # parallel sort keys
        self._used_seqs: set = set()
        self._discarded_unused = 0

    def __len__(self) -> int:
        return len(self._items)

    def add(self, priority: Tuple[float, float], data: Any) -> bool:
        """Insert; returns False if rejected (full and below the floor)."""
        if len(self._items) == self.maxsize:
            if priority < self._items[0][0]:
                self._discarded_unused += 1
                return False
        key = (priority, self._seq)
        idx = bisect.bisect_left(self._keys, key)
        self._keys.insert(idx, key)
        self._items.insert(idx, (priority, self._seq, data))
        self._seq += 1
        if len(self._items) > self.maxsize:
            _, seq, _ = self._items.pop(0)
            self._keys.pop(0)
            if seq not in self._used_seqs:
                self._discarded_unused += 1
            else:
                self._used_seqs.discard(seq)
        return True

    def topn(self, n: int) -> List[Any]:
        """Highest-priority-first view of the best n items (marked used)."""
        items = self._items[-n:]
        for _, seq, _ in items:
            self._used_seqs.add(seq)
        return [data for _, _, data in reversed(items)]

    def remove_below(self, threshold: float) -> None:
        """Drop items whose priority[0] (min_version) < threshold."""
        keep, dropped = [], []
        for item in self._items:
            (keep if item[0][0] >= threshold else dropped).append(item)
        for _, seq, _ in dropped:
            if seq not in self._used_seqs:
                self._discarded_unused += 1
            else:
                self._used_seqs.discard(seq)
        self._items = keep
        self._keys = [(p, s) for p, s, _ in keep]

    def get_metric(self) -> Dict:
        """Version-composition histogram over stored trajectories (items may
        expose a ``versions`` array) + the discarded-unused counter."""
        total = 0
        counts: Dict[int, int] = {}
        for _, _, data in self._items:
            versions = getattr(data, "versions", None)
            if versions is None:
                continue
            flat = np.round(np.asarray(versions).reshape(-1)).astype(np.int64)
            uniq, cnt = np.unique(flat, return_counts=True)
            for v, c in zip(uniq.tolist(), cnt.tolist()):
                counts[v] = counts.get(v, 0) + c
            total += flat.size
        if total == 0:
            return {"discarded_unused": self._discarded_unused}
        out: Dict = {v: {"ratio": c / total} for v, c in counts.items()}
        out["discarded_unused"] = self._discarded_unused
        return out
