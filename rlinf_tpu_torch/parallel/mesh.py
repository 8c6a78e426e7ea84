"""Meshes over ranks and component placement.

Port of ``rlinf_tpu/parallel/mesh.py``. The JAX package is one program over
a global device mesh; the port is one process per device (a rank) with
explicit collectives, as PyTorch (and the reference RLinf, one worker per
GPU) runs. A :class:`Mesh` is a ``torch.distributed.device_mesh.DeviceMesh``
over ranks with the JAX package's axis names and order (data, fsdp, expert,
context, tensor); each axis's process group is ``mesh.get_group(name)``.
The mesh adds the groups the DeviceMesh does not make: one for every set
of two or more of its axes of size > 1 (the batch axes data x fsdp, the
batch and context axes together, a leaf's sharding axes, all its ranks).

``torch.distributed.new_group`` must be called by every rank of the world
in the same order, also by ranks outside the group: so a mesh is built on
every rank, members or not, and :class:`ComponentPlacement` builds every
component's mesh on every rank, in the order of its components.

The active mesh (``use_mesh``) is what the model's forward reads, as the
JAX package's ``jax.set_mesh`` context is what its sharding constraints
read: outside one, every function runs as on one device.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import math
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class AxisNames:
    """The logical mesh axis names (the JAX package's)."""

    DATA = "data"
    FSDP = "fsdp"
    TENSOR = "tensor"
    CONTEXT = "context"
    EXPERT = "expert"

    ALL = (DATA, FSDP, TENSOR, CONTEXT, EXPERT)
    #: axes over which batch rows are split
    BATCH = (DATA, FSDP)


#: the mesh's axis order, slowest-varying first: tensor innermost (its
#: collectives run in every layer), data outermost (once a step)
MESH_ORDER = (AxisNames.DATA, AxisNames.FSDP, AxisNames.EXPERT,
              AxisNames.CONTEXT, AxisNames.TENSOR)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes of each logical axis; ``-1`` absorbs the remaining ranks."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    context: int = 1
    expert: int = 1

    def resolve(self, num_devices: int) -> "MeshConfig":
        """Fill the single -1 axis so the product equals ``num_devices``."""
        sizes = dataclasses.asdict(self)
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"At most one mesh axis may be -1, got {unknown}")
        known = math.prod(v for v in sizes.values() if v != -1)
        if unknown:
            if num_devices % known != 0:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes product {known}")
            sizes[unknown[0]] = num_devices // known
        elif known != num_devices:
            raise ValueError(
                f"Mesh axes product {known} != available devices {num_devices}")
        return MeshConfig(**sizes)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AxisNames.ALL}


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """A DeviceMesh over ``ranks`` in ``MESH_ORDER``, plus the batch group.

    ``shape`` maps each axis to its size, as ``jax.sharding.Mesh.shape``.
    Built by every rank of the world (see the module docstring); on a rank
    outside it, ``contains()`` is False and its groups are not this rank's.
    """

    def __init__(self, config: MeshConfig, ranks: Sequence[int], device_type: str):
        from torch.distributed.device_mesh import DeviceMesh

        self.ranks = [int(r) for r in ranks]
        cfg = config.resolve(len(self.ranks))
        self.config = cfg
        self.shape: Dict[str, int] = {a: getattr(cfg, a) for a in MESH_ORDER}
        self.device_type = device_type
        grid = torch.tensor(self.ranks, dtype=torch.int).reshape(tuple(self.shape.values()))
        self.grid = grid
        self.device_mesh = DeviceMesh(device_type, grid, mesh_dim_names=MESH_ORDER) \
            if dist.is_initialized() else None
        # one group for every set of two or more axes of size > 1 (the
        # batch axes, batch x context, the whole mesh, a leaf's sharding
        # axes), made in the same order on every rank
        self._groups: Dict[frozenset, object] = {}
        if dist.is_initialized():
            sized = [a for a in MESH_ORDER if self.shape[a] > 1]
            for n in range(2, len(sized) + 1):
                for axes in itertools.combinations(sized, n):
                    self._groups[frozenset(axes)] = self._combined_group(axes)

    # -- groups -----------------------------------------------------------
    def _combined_group(self, axes: Tuple[str, ...]):
        """One process group per slice of the mesh over ``axes`` together
        (created on every rank, in the same order); returns this rank's."""
        sized = [a for a in axes if self.shape[a] > 1]
        if len(sized) <= 1:
            return self.get_group(sized[0]) if sized else None
        if len(self.ranks) == _world_size() and all(
                a in axes for a in MESH_ORDER if self.shape[a] > 1):
            return dist.group.WORLD
        keep = [MESH_ORDER.index(a) for a in axes]
        rest = [i for i in range(len(MESH_ORDER)) if i not in keep]
        g = self.grid.permute(*rest, *keep).reshape(-1, math.prod(self.shape[a] for a in axes))
        mine = None
        for row in g.tolist():
            pg = dist.new_group(row)
            if _rank() in row:
                mine = pg
        return mine

    def get_group(self, axes):
        """This rank's process group over one axis or a tuple of axes (None
        where the axes are all of size 1: no communication)."""
        if isinstance(axes, str):
            if self.shape[axes] == 1 or self.device_mesh is None or not self.contains():
                return None
            return self.device_mesh.get_group(axes)
        sized = [a for a in axes if self.shape[a] > 1]
        if len(sized) <= 1:
            return self.get_group(sized[0]) if sized else None
        if self.device_mesh is None or not self.contains():
            return None
        return self._groups[frozenset(sized)]

    def size(self, axes=None) -> int:
        if axes is None:
            return len(self.ranks)
        if isinstance(axes, str):
            return self.shape[axes]
        return math.prod(self.shape[a] for a in axes)

    # -- this rank --------------------------------------------------------
    def contains(self, rank: Optional[int] = None) -> bool:
        return (_rank() if rank is None else rank) in self.ranks

    def coordinate(self, rank: Optional[int] = None) -> Dict[str, int]:
        r = _rank() if rank is None else rank
        flat = self.ranks.index(r)
        out = {}
        for a in reversed(MESH_ORDER):
            out[a] = flat % self.shape[a]
            flat //= self.shape[a]
        return {a: out[a] for a in MESH_ORDER}

    def axis_index(self, axes, rank: Optional[int] = None) -> int:
        """This rank's index along one axis or a tuple of axes (row-major)."""
        c = self.coordinate(rank)
        if isinstance(axes, str):
            return c[axes]
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def rank_at(self, **coords) -> int:
        return int(self.grid[tuple(coords.get(a, 0) for a in MESH_ORDER)])

    def __repr__(self) -> str:
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({shape}; ranks={self.ranks})"


def make_mesh(config: MeshConfig, ranks: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None) -> Mesh:
    """A :class:`Mesh` over ``ranks`` (default: every rank of the world).

    ``device_type`` defaults to "cuda" when this process has a card and
    "cpu" otherwise; a world of one process (no ``torch.distributed``)
    gives a mesh of one rank whose groups are all None."""
    if ranks is None:
        ranks = list(range(_world_size()))
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return Mesh(config, ranks, device_type)


class PlacementMode(Enum):
    COLLOCATED = "collocated"
    DISAGGREGATED = "disaggregated"
    HYBRID = "hybrid"


def _parse_range(spec, world_size: Optional[int] = None) -> List[int]:
    """'0-7', '0,2,4', 'all', an int or a list -> rank indices ('all' is
    every rank of the world)."""
    if isinstance(spec, int):
        return [spec]
    if isinstance(spec, (list, tuple)):
        return [int(x) for x in spec]
    spec = str(spec).strip()
    if spec == "all":
        return list(range(_world_size() if world_size is None else world_size))
    out: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


@dataclasses.dataclass
class ComponentPlacement:
    """Named components on rank sets, each with a mesh of its own.

    Overlapping rank sets are COLLOCATED (phases time-slice one set),
    disjoint ones DISAGGREGATED (weights move between the sets). Every
    component's mesh is built on every rank, in the order of
    ``components``, when the placement is made: a rank outside a component
    still takes part in making its groups."""

    components: Dict[str, object]
    mesh_configs: Dict[str, MeshConfig] = dataclasses.field(default_factory=dict)
    world_size: Optional[int] = None
    device_type: Optional[str] = None

    def __post_init__(self):
        n = self.world_size if self.world_size is not None else _world_size()
        self.world_size = n
        self._indices: Dict[str, List[int]] = {
            name: _parse_range(spec, n) for name, spec in self.components.items()
        }
        for name, idx in self._indices.items():
            bad = [i for i in idx if i >= n]
            if bad:
                raise ValueError(
                    f"Component {name!r} requests device indices {bad} but only "
                    f"{n} devices exist")
        self._meshes: Dict[str, Mesh] = {}
        if dist.is_initialized():
            for name in self._indices:
                self.mesh(name)

    def device_indices(self, component: str) -> List[int]:
        return list(self._indices[component])

    def mesh(self, component: str) -> Mesh:
        if component not in self._meshes:
            cfg = self.mesh_configs.get(component, MeshConfig())
            self._meshes[component] = make_mesh(
                cfg, self._indices[component], self.device_type)
        return self._meshes[component]

    @property
    def mode(self) -> PlacementMode:
        sets = [frozenset(v) for v in self._indices.values()]
        if len(sets) <= 1 or all(s == sets[0] for s in sets):
            return PlacementMode.COLLOCATED
        disjoint = all(not (a & b) for i, a in enumerate(sets) for b in sets[i + 1:])
        return PlacementMode.DISAGGREGATED if disjoint else PlacementMode.HYBRID

    def pairwise_overlap(self, a: str, b: str) -> Tuple[bool, bool]:
        """(share_all, share_any) between two components' rank sets."""
        sa, sb = set(self._indices[a]), set(self._indices[b])
        return sa == sb, bool(sa & sb)


# ---------------------------------------------------------------------------
# The active mesh
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("rlinf_active_mesh", default=None)


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``use_mesh`` block, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the active mesh inside the block (None: no mesh)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)
