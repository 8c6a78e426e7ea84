"""Learner -> rollout weight synchronization across disjoint rank sets.

Port of ``rlinf_tpu/parallel/weight_sync.py``. The JAX package
device-puts the learner's params onto the rollout mesh and lets the
runtime move the shards. Here the learner's (actor's) params are blocks on
the actor ranks and the transfer is explicit: for each block of each leaf,
its owner (the first actor rank that holds it) broadcasts it to the
rollout ranks, over a group of the owner and the rollout ranks (one group
per owner, made on every rank when the syncer is built). Each rollout
rank assembles the whole leaves and keeps its block under the rollout
mesh's rules. Every rank of the world calls ``sync`` in the same order:
an actor rank passes its params and gets None, a rollout rank passes
None and gets its rollout params. Bytes go as ``uint8`` views, so any
dtype rides gloo, whose CUDA tensors take ``broadcast``.

  WeightSyncer        one broadcast per block (the bucket syncer with
                      buckets of one block)
  BucketWeightSyncer  an owner's blocks packed into buckets of about
                      ``bucket_bytes``, one broadcast a bucket
  PatchWeightSyncer   after a first full sync, only the per-block int8
                      quantized delta (``compression="int8"``) or the
                      top-k entries of the delta with error feedback
                      (``"topk"``) against a snapshot that mirrors the
                      rollout side's reconstruction, so the error never
                      accumulates

Every ``sync`` adds one to ``version`` (the decoupled-PPO policy lag) and
sets ``last_bytes_sent`` (the payload bytes that left the owners).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rlinf_tpu_torch.parallel import collectives as C
from rlinf_tpu_torch.parallel.sharding import (
    Layout, _axes, flatten_with_paths, local_block,
)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


class WeightSyncer:
    """Full transfer: every block of every leaf, each in a broadcast of
    its own."""

    bucket_bytes = 0

    def __init__(self, target_mesh, target_rules, *, source_mesh, source_rules,
                 full_shapes, dtype: Optional[torch.dtype] = None, device="cuda"):
        """``full_shapes``: the params' tree with whole shapes and dtypes
        (meta tensors will do); ``source_mesh``/``source_rules``: the
        actor's mesh and rules; ``dtype``: the floating leaves arrive in
        it (None: their own)."""
        self.target_mesh, self.source_mesh = target_mesh, source_mesh
        self.src = Layout.from_rules(source_mesh, source_rules, full_shapes)
        self.dst = Layout.from_rules(target_mesh, target_rules, full_shapes)
        self.leaves: List[Tuple[str, tuple, torch.dtype]] = [
            (p, tuple(t.shape), t.dtype) for p, t in flatten_with_paths(full_shapes)]
        self.dtype = dtype
        self.device = torch.device(device)
        self.version = 0
        self.last_bytes_sent = 0
        self.is_target = target_mesh.contains()
        self._groups: Dict[int, Any] = {}
        for owner in sorted(set(self._owner(p, b) for p, shape, _ in self.leaves
                                for b in self._blocks(p))):
            ranks = sorted(set([owner] + target_mesh.ranks))
            g = dist.new_group(ranks)
            if _rank() in ranks:
                self._groups[owner] = g
        self._full: Optional[Dict[str, torch.Tensor]] = None

    # -- the plan (the same on every rank) ---------------------------------
    def _blocks(self, path) -> List[Tuple[int, ...]]:
        """Block indices of a leaf along its sharded axes (one () block for
        a replicated leaf)."""
        spec = self.src.specs[path]
        sizes = [self.source_mesh.size(_axes(a)) for a in spec if a is not None]
        return list(itertools.product(*(range(n) for n in sizes)))

    def _owner(self, path, block) -> int:
        spec = self.src.specs[path]
        coords, i = {}, 0
        for entry in spec:
            if entry is None:
                continue
            idx = block[i]
            i += 1
            for a in reversed(_axes(entry)):
                coords[a] = idx % self.source_mesh.size(a)
                idx //= self.source_mesh.size(a)
        return self.source_mesh.rank_at(**coords)

    def _region(self, full: torch.Tensor, path, block) -> torch.Tensor:
        """The view of a whole leaf that ``block`` covers."""
        spec, i = self.src.specs[path], 0
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            n = self.source_mesh.size(_axes(entry))
            k = full.shape[dim] // n
            full = full.narrow(dim, block[i] * k, k)
            i += 1
        return full

    def _wire_dtype(self, dtype):
        return self.dtype if (self.dtype is not None and dtype.is_floating_point) else dtype

    def _plan(self):
        """Buckets: (owner, wire dtype, [(path, block, numel)]) in a fixed
        order, each up to about ``bucket_bytes``."""
        by_owner: Dict[Tuple[int, torch.dtype], list] = {}
        for path, shape, dt in self.leaves:
            numel = int(np.prod(shape)) // max(1, len(self._blocks(path)))
            for b in self._blocks(path):
                key = (self._owner(path, b), self._wire_dtype(dt))
                by_owner.setdefault(key, []).append((path, b, numel))
        plan = []
        for (owner, dt), items in sorted(by_owner.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
            cur, size = [], 0
            esize = torch.empty((), dtype=dt).element_size()
            for it in items:
                cur.append(it)
                size += it[2] * esize
                if size >= self.bucket_bytes:
                    plan.append((owner, dt, cur))
                    cur, size = [], 0
            if cur:
                plan.append((owner, dt, cur))
        return plan

    # -- transfer ------------------------------------------------------------
    def _local(self, params) -> Dict[str, torch.Tensor]:
        return dict(flatten_with_paths(params)) if params is not None else {}

    def _full_transfer(self, params) -> int:
        """Every block to the rollout ranks (into ``self._full``); returns
        the bytes sent."""
        mine = self._local(params)
        if self.is_target and self._full is None:
            self._full = {p: torch.empty(shape, dtype=self._wire_dtype(dt), device=self.device)
                          for p, shape, dt in self.leaves}
        sent = 0
        for owner, dt, items in self._plan():
            esize = torch.empty((), dtype=dt).element_size()
            n = sum(numel for _, _, numel in items)
            sent += n * esize
            group = self._groups.get(owner)
            if group is None:
                continue
            if _rank() == owner:
                buf = torch.cat([mine[p].reshape(-1).to(dt) for p, _, _ in items]) \
                    if len(items) > 1 else mine[items[0][0]].reshape(-1).to(dt)
            else:
                buf = torch.empty(n, dtype=dt, device=self.device)
            C.broadcast_(_bytes(buf), owner, group)
            if self.is_target:
                off = 0
                for p, b, numel in items:
                    region = self._region(self._full[p], p, b)
                    region.copy_(buf[off:off + numel].view(region.shape))
                    off += numel
        return sent

    def _target_params(self):
        if not self.is_target:
            return None
        return _unflatten({p: local_block(t, self.dst.specs[p], self.target_mesh).contiguous()
                           if self.dst.specs[p] else t for p, t in self._full.items()})

    def sync(self, params) -> Any:
        with torch.no_grad():
            self.last_bytes_sent = self._full_transfer(params)
        self.version += 1
        return self._target_params()

    def full_params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The whole leaves a rollout rank holds after the last sync."""
        return None if self._full is None else _unflatten(dict(self._full))


class BucketWeightSyncer(WeightSyncer):
    """An owner's blocks packed into buckets of ~``bucket_bytes``: one
    broadcast a bucket, at most one bucket staged at a time."""

    def __init__(self, target_mesh, target_rules, *, bucket_bytes: int = 512 << 20, **kw):
        self.bucket_bytes = bucket_bytes
        super().__init__(target_mesh, target_rules, **kw)


class PatchWeightSyncer(WeightSyncer):
    """Delta sync after a first full one (see the module docstring)."""

    def __init__(self, target_mesh, target_rules, *, quantize: bool = True,
                 compression: str = "int8", block_size: int = 256,
                 topk_ratio: float = 0.05, **kw):
        super().__init__(target_mesh, target_rules, **kw)
        if compression not in ("int8", "topk"):
            raise ValueError(f"compression must be int8 | topk, got {compression!r}")
        self.quantize = quantize
        self.compression = compression
        self.block_size = block_size
        self.topk_ratio = topk_ratio
        self._snapshot: Optional[Dict[str, torch.Tensor]] = None

    def _encode_int8(self, delta):
        return encode_int8(delta, self.block_size)

    def _encode_topk(self, delta):
        return encode_topk(delta, self.topk_ratio)

    def _payload_shapes(self, numel: int):
        if self.compression == "topk":
            k = max(int(numel * self.topk_ratio), 1)
            return [((k,), torch.bfloat16), ((k,), torch.int32)]
        nb = -(-numel // self.block_size)
        return [((nb, self.block_size), torch.int8), ((nb,), torch.float32)]

    def sync(self, params) -> Any:
        with torch.no_grad():
            if self._snapshot is None:
                self.last_bytes_sent = self._full_transfer(params)
                mine = self._local(params)
                # a copy, not an alias: the train step updates params in place
                self._snapshot = {p: t.clone() for p, t in mine.items()}
            else:
                self.last_bytes_sent = self._patch(params)
        self.version += 1
        return self._target_params()

    def _patch(self, params) -> int:
        mine = self._local(params)
        sent = 0
        for path, shape, dt in self.leaves:
            for b in self._blocks(path):
                owner = self._owner(path, b)
                numel = int(np.prod(shape)) // len(self._blocks(path))
                group = self._groups.get(owner)
                if not dt.is_floating_point or not self.quantize:
                    # whole block, as the full transfer sends it
                    sent += numel * torch.empty((), dtype=self._wire_dtype(dt)).element_size()
                    if group is None:
                        continue
                    buf = (mine[path].reshape(-1).to(self._wire_dtype(dt)) if _rank() == owner
                           else torch.empty(numel, dtype=self._wire_dtype(dt), device=self.device))
                    C.broadcast_(_bytes(buf), owner, group)
                    if _rank() == owner:
                        self._snapshot[path].copy_(mine[path])
                    if self.is_target:
                        region = self._region(self._full[path], path, b)
                        region.copy_(buf.view(region.shape))
                    continue
                pay_shapes = self._payload_shapes(numel)
                sent += sum(int(np.prod(s)) * torch.empty((), dtype=d).element_size()
                            for s, d in pay_shapes)
                if group is None:
                    continue
                if _rank() == owner:
                    new, old = mine[path], self._snapshot[path]
                    delta = new.float() - old.float()
                    payload = list(self._encode_topk(delta) if self.compression == "topk"
                                   else self._encode_int8(delta))
                else:
                    payload = [torch.empty(s, dtype=d, device=self.device) for s, d in pay_shapes]
                for t in payload:
                    C.broadcast_(_bytes(t), owner, group)
                decode = decode_topk if self.compression == "topk" else decode_int8
                if _rank() == owner:
                    # the source's mirror of the reconstruction: same arithmetic
                    dec = decode(*payload, self._snapshot[path].shape)
                    snap = self._snapshot[path]
                    snap.copy_((snap.float() + dec).to(snap.dtype))
                if self.is_target:
                    region = self._region(self._full[path], path, b)
                    dec = decode(*payload, region.shape)
                    region.copy_((region.float() + dec).to(region.dtype))
        return sent


# ---------------------------------------------------------------------------
# Delta codecs (the JAX package's arithmetic)
# ---------------------------------------------------------------------------

def encode_int8(delta: torch.Tensor, block_size: int):
    """delta -> (q int8 [nb, B], scales f32 [nb]): symmetric int8 per block
    of ``block_size`` (the flattened delta, zero-padded to whole blocks)."""
    flat = delta.reshape(-1).float()
    n = flat.numel()
    nb = -(-n // block_size)
    blocks = torch.zeros(nb * block_size, dtype=torch.float32, device=flat.device)
    blocks[:n] = flat
    blocks = blocks.view(nb, block_size)
    scales = torch.clamp_min(blocks.abs().amax(dim=1), 1e-12) / 127.0
    q = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127).to(torch.int8)
    return q, scales


def decode_int8(q: torch.Tensor, scales: torch.Tensor, shape) -> torch.Tensor:
    n = int(np.prod(shape))
    return (q.float() * scales[:, None]).reshape(-1)[:n].reshape(shape)


def encode_topk(delta: torch.Tensor, ratio: float):
    """delta -> (values bf16 [k], indices int32 [k]) of the k = ratio x n
    largest |delta| entries."""
    flat = delta.reshape(-1).float()
    k = max(int(flat.numel() * ratio), 1)
    idx = torch.topk(flat.abs(), k).indices
    return flat[idx].to(torch.bfloat16), idx.to(torch.int32)


def decode_topk(values: torch.Tensor, idx: torch.Tensor, shape) -> torch.Tensor:
    n = int(np.prod(shape))
    flat = torch.zeros(n, dtype=torch.float32, device=values.device)
    flat[idx.long()] = values.float()
    return flat.reshape(shape)


_SYNCER_REGISTRY: Dict[str, type] = {
    "full": WeightSyncer,
    "bucket": BucketWeightSyncer,
    "patch": PatchWeightSyncer,
}


def make_weight_syncer(kind: str, target_mesh, target_rules, **kw) -> WeightSyncer:
    """The syncer named ``kind`` (full | bucket | patch)."""
    try:
        cls = _SYNCER_REGISTRY[kind]
    except KeyError:
        raise KeyError(
            f"Unknown weight syncer {kind!r}; have {sorted(_SYNCER_REGISTRY)}") from None
    return cls(target_mesh, target_rules, **kw)
