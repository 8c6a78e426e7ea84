"""Named in-process channels: the dataflow primitive between components.

A copy of ``rlinf_tpu/parallel/channel.py``: named FIFO queues with
key -> queue routing, per-item weights and ``get_batch(target_weight)``
(weight = a token count, for token-budget batch assembly). A channel is a
thread-safe queue of this process, as in the JAX package; across the
port's ranks the data moves through ``parallel/collectives.py`` and the
weight syncers, not through channels.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional, Tuple


class Channel:
    _registry: Dict[str, "Channel"] = {}
    _registry_lock = threading.Lock()

    def __init__(self, name: str, maxsize: int = 0):
        self.name = name
        self._queues: Dict[Optional[str], "queue.Queue"] = {}
        self._lock = threading.Lock()
        self._maxsize = maxsize

    # -- creation / lookup (reference Worker.create_channel/connect_channel)
    @classmethod
    def create(cls, name: str, maxsize: int = 0) -> "Channel":
        with cls._registry_lock:
            if name in cls._registry:
                raise ValueError(f"channel {name!r} already exists")
            ch = cls(name, maxsize)
            cls._registry[name] = ch
            return ch

    @classmethod
    def connect(cls, name: str) -> "Channel":
        with cls._registry_lock:
            try:
                return cls._registry[name]
            except KeyError:
                raise KeyError(f"no channel named {name!r}") from None

    @classmethod
    def reset_registry(cls):
        with cls._registry_lock:
            cls._registry.clear()

    def _q(self, key: Optional[str]) -> "queue.Queue":
        with self._lock:
            if key not in self._queues:
                self._queues[key] = queue.Queue(maxsize=self._maxsize)
            return self._queues[key]

    # -- data plane ----------------------------------------------------
    def put(
        self,
        item: Any,
        *,
        key: Optional[str] = None,
        weight: float = 1.0,
        block: bool = True,
        timeout: Optional[float] = None,
    ):
        self._q(key).put((weight, item), block=block, timeout=timeout)

    def get(
        self,
        *,
        key: Optional[str] = None,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> Any:
        return self._q(key).get(block=block, timeout=timeout)[1]

    def get_batch(
        self,
        target_weight: float,
        *,
        key: Optional[str] = None,
        timeout: Optional[float] = None,
    ) -> List[Any]:
        """Pop items until accumulated weight >= target_weight (reference
        channel.py:563 weighted batching — e.g. weight=token count for
        token-budget batch assembly)."""
        q = self._q(key)
        items: List[Any] = []
        total = 0.0
        while total < target_weight:
            try:
                w, item = q.get(block=not items if timeout is None else True,
                                timeout=timeout)
            except queue.Empty:
                break
            items.append(item)
            total += w
            if timeout is None and q.empty() and total >= target_weight:
                break
        return items

    def qsize(self, key: Optional[str] = None) -> int:
        return self._q(key).qsize()

    def empty(self, key: Optional[str] = None) -> bool:
        return self._q(key).empty()
