"""Trajectory replay buffer: in-memory ring + disk-backed store.

Port of ``rlinf_tpu/data/replay_buffer.py``: pure numpy, a copy.

Re-design of the reference's TrajectoryReplayBuffer
(reference rlinf/data/replay_buffer.py:227-536: per-trajectory files with a
metadata index, async flush, weighted sampling, save/resume) and the
in-memory TrajectoryCache (:46). Used by SAC/offline/async flows.

Items are dicts of numpy arrays (one trajectory or transition batch).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class BufferItem:
    data: Dict[str, np.ndarray]
    weight: float = 1.0
    meta: Optional[dict] = None


class ReplayBuffer:
    """Bounded in-memory store with weighted sampling and optional disk
    persistence.

    ``capacity`` counts items (trajectories); eviction is FIFO. ``sample``
    draws with probability proportional to item weight (reference
    weighted-sampling semantics, replay_buffer.py get_batch analog).
    """

    def __init__(
        self,
        capacity: int = 10000,
        *,
        directory: Optional[str] = None,
        seed: int = 0,
        flush_async: bool = True,
    ):
        self.capacity = capacity
        self.directory = directory
        self._items: deque = deque()
        self._rng = np.random.default_rng(seed)
        self._next_id = 0
        self._lock = threading.Lock()
        self._flush_async = flush_async
        self._flush_threads: List[threading.Thread] = []
        if directory:
            os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def total_transitions(self) -> int:
        with self._lock:
            return sum(
                next(iter(it.data.values())).shape[0] for _, it in self._items
            )

    def add(self, data: Dict[str, np.ndarray], weight: float = 1.0,
            meta: Optional[dict] = None):
        item = BufferItem(
            data={k: np.asarray(v) for k, v in data.items()},
            weight=float(weight),
            meta=meta,
        )
        with self._lock:
            item_id = self._next_id
            self._next_id += 1
            self._items.append((item_id, item))
            evicted = []
            while len(self._items) > self.capacity:
                evicted.append(self._items.popleft())
        if self.directory:
            self._persist(item_id, item)
            for eid, _ in evicted:
                self._unlink(eid)

    def _path(self, item_id: int) -> str:
        return os.path.join(self.directory, f"traj_{item_id:08d}.npz")

    def _persist(self, item_id: int, item: BufferItem):
        def write():
            np.savez_compressed(
                self._path(item_id), __weight__=item.weight, **item.data
            )
        if self._flush_async:
            t = threading.Thread(target=write, daemon=True)
            t.start()
            self._flush_threads.append(t)
            self._flush_threads = [t for t in self._flush_threads if t.is_alive()]
        else:
            write()

    def _unlink(self, item_id: int):
        try:
            os.unlink(self._path(item_id))
        except FileNotFoundError:
            pass

    def flush(self):
        for t in self._flush_threads:
            t.join()
        self._flush_threads.clear()
        if self.directory:
            with self._lock:
                index = {
                    "next_id": self._next_id,
                    "ids": [i for i, _ in self._items],
                }
            with open(os.path.join(self.directory, "index.json"), "w") as f:
                json.dump(index, f)

    # ------------------------------------------------------------------
    def sample(self, n: int, replace: bool = True) -> List[BufferItem]:
        with self._lock:
            items = [it for _, it in self._items]
        if not items:
            raise ValueError("sampling from empty replay buffer")
        w = np.asarray([it.weight for it in items], np.float64)
        p = w / w.sum()
        idx = self._rng.choice(len(items), size=n, replace=replace, p=p)
        return [items[i] for i in idx]

    def sample_transitions(self, batch_size: int) -> Dict[str, np.ndarray]:
        """Uniformly sample individual transitions across stored items (the
        SAC path: items are transition batches with a shared leading dim)."""
        with self._lock:
            items = [it for _, it in self._items]
        if not items:
            raise ValueError("sampling from empty replay buffer")
        sizes = np.asarray(
            [next(iter(it.data.values())).shape[0] for it in items]
        )
        total = sizes.sum()
        flat_idx = self._rng.integers(0, total, size=batch_size)
        cum = np.cumsum(sizes)
        item_idx = np.searchsorted(cum, flat_idx, side="right")
        local_idx = flat_idx - np.concatenate([[0], cum[:-1]])[item_idx]
        keys = items[0].data.keys()
        out = {}
        for k in keys:
            out[k] = np.stack(
                [items[i].data[k][j] for i, j in zip(item_idx, local_idx)]
            )
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def restore(directory: str, capacity: int = 10000, seed: int = 0
                ) -> "ReplayBuffer":
        """Rebuild from disk (reference save/resume, replay_buffer.py:357-439)."""
        buf = ReplayBuffer(capacity, directory=directory, seed=seed)
        index_path = os.path.join(directory, "index.json")
        ids: Sequence[int]
        if os.path.exists(index_path):
            with open(index_path) as f:
                index = json.load(f)
            ids = index["ids"]
            buf._next_id = index["next_id"]
        else:
            ids = sorted(
                int(name[5:13]) for name in os.listdir(directory)
                if name.startswith("traj_") and name.endswith(".npz")
            )
            buf._next_id = (max(ids) + 1) if ids else 0
        for item_id in ids:
            path = buf._path(item_id)
            if not os.path.exists(path):
                continue
            with np.load(path) as z:
                weight = float(z["__weight__"])
                data = {k: z[k] for k in z.files if k != "__weight__"}
            buf._items.append((item_id, BufferItem(data=data, weight=weight)))
        return buf
