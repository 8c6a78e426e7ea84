"""Partition rules: regex path -> partition spec, applied over param trees.

Port of ``rlinf_tpu/parallel/sharding.py``. A spec is a tuple with one
entry per leading dim: a mesh axis name, a tuple of axis names (that dim
split over the axes together, row-major) or None; trailing dims not named
are whole. ``P(...)`` builds one, as ``jax.sharding.PartitionSpec``.

Where the JAX package device-puts a leaf with a ``NamedSharding`` and XLA
keeps the layout, a leaf on a rank here IS the rank's block:
``shard_pytree`` turns full tensors into blocks and ``gather_pytree``
turns blocks back into full tensors, both under the specs that
``tree_shardings`` resolved against the FULL shapes (a dim not divisible
by its axes stays whole, ``_valid_spec_for``). A tree's resolved specs are
what every later gather, reduction and checkpoint of its blocks reads.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from rlinf_tpu_torch.parallel import collectives as C

PartitionSpec = tuple
#: ordered (regex, spec) pairs; the first match wins
PartitionRules = Sequence[Tuple[str, PartitionSpec]]


def P(*axes) -> PartitionSpec:
    """A partition spec, as ``jax.sharding.PartitionSpec(*axes)``."""
    return tuple(axes)


def _is_tree(x) -> bool:
    return isinstance(x, dict)


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """``[(path, leaf)]`` of a nested dict, paths joined by "/"."""
    if _is_tree(tree):
        out = []
        for k, v in tree.items():
            out.extend(flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return [(prefix, tree)]


def _map_with_paths(fn, tree, *rest, prefix: str = ""):
    if _is_tree(tree):
        return {k: _map_with_paths(fn, v, *(r[k] for r in rest),
                                   prefix=f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree, *rest)


def _shape(leaf) -> Optional[tuple]:
    s = getattr(leaf, "shape", None)
    return None if s is None else tuple(s)


def match_partition_rules(rules: PartitionRules, params):
    """A tree of specs in ``params``' structure. Scalar and single-element
    leaves are replicated; a leaf no rule matches raises (silent
    replication of a large tensor is a bug, not a default)."""

    def spec_for(name: str, leaf):
        shape = _shape(leaf)
        if shape is None or int(np.prod(shape or (1,))) == 1:
            return P()
        for pattern, spec in rules:
            if re.search(pattern, name):
                return spec
        raise ValueError(f"No partition rule matched parameter {name!r}")

    return _map_with_paths(spec_for, params)


def _axes(entry) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _valid_spec_for(leaf, spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop the sharding of a dim that its axes' size does not divide (or
    of size-1 axes), so tiny test models keep working."""
    shape = _shape(leaf)
    if shape is None:
        return P()
    out = []
    for dim, axis in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axis is None:
            out.append(None)
            continue
        size = int(np.prod([mesh.shape[a] for a in _axes(axis)]))
        out.append(axis if shape[dim] % size == 0 and size > 1 else None)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def tree_shardings(tree, specs, mesh, validate: bool = True):
    """The resolved spec of every leaf of the FULL ``tree`` (tensors or
    anything with a shape), in its structure."""
    return _map_with_paths(
        lambda _p, leaf, spec: _valid_spec_for(leaf, spec, mesh) if validate else spec,
        tree, specs)


def local_block(t: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under a resolved spec
    (a view where one dim is split; ``contiguous()`` makes it a tensor of
    its own)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        axes = _axes(axis)
        n = mesh.size(axes)
        k = t.shape[dim] // n
        t = t.narrow(dim, mesh.axis_index(axes) * k, k)
    return t


def gather_block(t: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """The full tensor from this rank's block under a resolved spec, on
    every rank of the mesh (no autograd)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        t = C.gather_tensor(t, dim, mesh.get_group(_axes(axis)))
    return t


def shard_pytree(tree, specs, mesh, validate: bool = True):
    """Full leaves -> this rank's blocks (each a tensor of its own)."""

    def put(_p, leaf, spec):
        s = _valid_spec_for(leaf, spec, mesh) if validate else spec
        if not torch.is_tensor(leaf):
            return leaf
        return local_block(leaf, s, mesh).contiguous().clone() if s else leaf

    return _map_with_paths(put, tree, specs)


def gather_pytree(tree, shardings, mesh):
    """This rank's blocks -> the full leaves, on every rank (the inverse of
    ``shard_pytree`` under the resolved specs of ``tree_shardings``)."""
    return _map_with_paths(
        lambda _p, leaf, spec: gather_block(leaf, spec, mesh) if torch.is_tensor(leaf) else leaf,
        tree, shardings)


def sharded_axes(spec: PartitionSpec) -> Tuple[str, ...]:
    """The mesh axes a resolved spec splits the leaf over."""
    return tuple(a for entry in spec if entry is not None for a in _axes(entry))


def context_chunk(x: torch.Tensor, mesh, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous chunk of ``x`` along ``dim`` (the sequence)
    over the mesh's context axis: rank i of the context group takes
    [i*S/cp, (i+1)*S/cp), the JAX layout ``P(None, "context")``. A length
    that the context axis does not divide raises, as JAX's shard_map."""
    cp = mesh.size("context")
    if cp == 1:
        return x
    n = x.shape[dim]
    if n % cp:
        raise ValueError(f"sequence length {n} not divisible by mesh.context ({cp}): "
                         "ring attention shards the sequence evenly")
    k = n // cp
    return x.narrow(dim, mesh.axis_index("context") * k, k)


def logical_to_mesh_axes(
    logical_axes: Sequence[Optional[str]],
    mapping: Dict[str, Union[str, Tuple[str, ...], None]],
) -> PartitionSpec:
    """Translate logical axis names (e.g. 'embed', 'vocab') into mesh axes."""
    return P(*(mapping.get(a) if a is not None else None for a in logical_axes))


def with_sharding_constraint(x, spec: PartitionSpec):
    """The JAX package's layout hint. A tensor on a rank is the block it
    holds, and the port's functions move blocks explicitly, so there is
    nothing to constrain: ``x`` is returned as it is."""
    del spec
    return x


def _trim(spec: PartitionSpec) -> PartitionSpec:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


class Layout:
    """Resolved specs by parameter path, for trees whose paths end with a
    parameter's path (the optimizer state's ``mu/blocks/wq``, a
    checkpoint's ``/1/blocks/wq``): the longest parameter path that ends
    the leaf's path gives its spec, where the local shapes agree. A leaf
    under ``v_row/`` or ``v_col/`` (adafactor's factored statistics: the
    parameter's shape without its largest or its second largest dim)
    takes the parameter's spec without that dim."""

    def __init__(self, mesh, specs: Dict[str, PartitionSpec], local_shapes: Dict[str, tuple]):
        self.mesh = mesh
        self.specs = dict(specs)
        self.local_shapes = dict(local_shapes)
        self._by_len = sorted(self.specs, key=len, reverse=True)

    @classmethod
    def from_rules(cls, mesh, rules: PartitionRules, full_tree) -> "Layout":
        specs = tree_shardings(full_tree, match_partition_rules(rules, full_tree), mesh)
        flat_specs = dict(flatten_with_paths(specs))
        local = {}
        for path, leaf in flatten_with_paths(full_tree):
            shape = list(_shape(leaf) or ())
            for dim, axis in enumerate(flat_specs[path]):
                if axis is not None:
                    shape[dim] //= mesh.size(_axes(axis))
            local[path] = tuple(shape)
        return cls(mesh, flat_specs, local)

    def _forms(self, p: str, path: str):
        """(local shape, spec) of the leaf at ``path``, a state of the
        parameter at ``p``: the parameter's own, or under ``v_row``/``v_col``
        also its factored statistic's."""
        from rlinf_tpu_torch.training.train_state import factored_dims

        local, spec = self.local_shapes[p], self.specs[p]
        yield local, spec
        parts = path.split("/")
        stat = 0 if "v_row" in parts else 1 if "v_col" in parts else None
        if stat is None:
            return
        full = list(local)
        for dim, axis in enumerate(spec):
            if axis is not None:
                full[dim] *= self.mesh.size(_axes(axis))
        dims = factored_dims(tuple(full))
        if dims is None:
            return
        padded = list(spec) + [None] * (len(local) - len(spec))
        d = dims[1] if stat == 0 else dims[0]       # v_row drops the largest dim
        yield local[:d] + local[d + 1:], P(*padded[:d], *padded[d + 1:])

    def spec_for(self, path: str, local_shape=None) -> PartitionSpec:
        path = path.strip("/")
        for p in self._by_len:
            if path == p or path.endswith("/" + p):
                if local_shape is None:
                    return self.specs[p]
                for shape, spec in self._forms(p, path):
                    if tuple(local_shape) == tuple(shape):
                        return _trim(spec)
        return P()

    def shard(self, tree, prefix: str = ""):
        """Full leaves of any tree whose paths end with parameter paths ->
        this rank's blocks."""
        def put(path, leaf):
            if not torch.is_tensor(leaf):
                return leaf
            spec = self.full_spec(path, leaf)
            return local_block(leaf, spec, self.mesh).contiguous().clone() if spec else leaf
        return _map_with_paths(put, tree, prefix=prefix)

    def full_spec(self, path, leaf):
        path = path.strip("/")
        for p in self._by_len:
            if path == p or path.endswith("/" + p):
                for shape, spec in self._forms(p, path):
                    want = list(shape)
                    for dim, axis in enumerate(spec):
                        if axis is not None:
                            want[dim] *= self.mesh.size(_axes(axis))
                    if tuple(leaf.shape) == tuple(want):
                        return _trim(spec)
        return P()

    def gather(self, tree, prefix: str = ""):
        """This rank's blocks -> full leaves, on every rank."""
        return _map_with_paths(
            lambda path, leaf: gather_block(leaf, self.spec_for(path, leaf.shape), self.mesh)
            if torch.is_tensor(leaf) else leaf, tree, prefix=prefix)

    def shard_count(self, path: str, local_shape=None) -> int:
        """How many distinct blocks the leaf is split into."""
        return int(np.prod([self.mesh.size(a) for a in sharded_axes(
            self.spec_for(path, local_shape))] or [1]))
