"""Checkpoints with auto-resume and the dataloader state.

The port's analog of ``rlinf_tpu/utils/checkpoint.py``, with its layout:
``<root>/global_step_N/`` holds the state, ``extra.json`` (the dataloader
position and other JSON state) and ``_DONE``, written last, so a step
without ``_DONE`` is never restored; ``latest_step`` is the highest done
step, and a save keeps the newest ``max_to_keep`` steps.

The state (any tree of dicts, lists, tuples and NamedTuples with tensors,
numbers and strings as leaves) is saved with ``torch.save`` as a flat
``{path: leaf}`` dict and restored with ``torch.load(weights_only=True)``
onto the template's device, each leaf held to the template's shape, type
and dtype. One exception: a floating leaf of a ``TrainState``'s
``opt_state`` may come back wider than the template's, because adam's
moments start in the parameters' dtype and the first update promotes
them (bf16 moments updated with f32 gradients become f32, as in optax),
so a template built before any step is narrower there. These
checkpoints are not orbax checkpoints: the JAX package cannot read them,
nor the port the JAX package's.

A manager given a ``layout`` (``parallel.sharding.Layout``: the specs of
a sharded state's leaves on its mesh) saves and restores a sharded state:
the save gathers every leaf whole and the mesh's first rank writes the
single-card layout; a restore loads the whole leaves on every rank and
keeps each rank's block. So a checkpoint written at one mesh restores at
any other, and on one card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

STATE_FILE = "state.pt"


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` of a tree of dicts, lists and tuples, in order; a
    path is the keys and indices joined by "/"."""
    if isinstance(tree, dict):
        items = (flatten(v, f"{prefix}/{k}") for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = (flatten(v, f"{prefix}/{i}") for i, v in enumerate(tree))
    else:
        return {prefix: tree.detach() if isinstance(tree, torch.Tensor) else tree}
    return {k: v for d in items for k, v in d.items()}


def _widened(saved: torch.dtype, want: torch.dtype) -> bool:
    return (saved.is_floating_point and want.is_floating_point
            and torch.finfo(saved).bits > torch.finfo(want).bits)


def _rebuild(template, prefix: str, flat: Dict[str, Any], widen: bool = False,
             block=None):
    """``template``'s structure with the leaves of ``flat``; ``widen``: the
    subtree's floating leaves may be wider than the template's; ``block``:
    (path, whole tensor) -> this rank's block."""
    if isinstance(template, dict):
        return {k: _rebuild(v, f"{prefix}/{k}", flat, widen, block)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        fields = getattr(template, "_fields", None)          # NamedTuple
        items = [_rebuild(v, f"{prefix}/{i}", flat,
                          widen or (fields is not None and fields[i] == "opt_state"), block)
                 for i, v in enumerate(template)]
        return type(template)(*items) if fields else type(template)(items)
    if prefix not in flat:
        raise ValueError(f"checkpoint has no leaf {prefix!r}")
    got = flat[prefix]
    if block is not None and isinstance(got, torch.Tensor):
        got = block(prefix, got)
    if isinstance(template, torch.Tensor):
        if not isinstance(got, torch.Tensor):
            raise ValueError(f"{prefix}: checkpoint holds {type(got).__name__}, not a tensor")
        if tuple(got.shape) != tuple(template.shape):
            raise ValueError(f"{prefix}: shape {tuple(got.shape)} in the checkpoint, "
                             f"{tuple(template.shape)} in the template")
        if got.dtype != template.dtype and not (widen and _widened(got.dtype, template.dtype)):
            raise ValueError(f"{prefix}: dtype {got.dtype} in the checkpoint, "
                             f"{template.dtype} in the template")
        return got.to(template.device)
    if type(got) is not type(template):
        raise ValueError(f"{prefix}: {type(got).__name__} in the checkpoint, "
                         f"{type(template).__name__} in the template")
    return got


class CheckpointManager:
    def __init__(self, root_dir: str, max_to_keep: int = 3, layout=None):
        self.root_dir = os.path.abspath(root_dir)
        os.makedirs(self.root_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.layout = layout

    def _writer(self) -> bool:
        """Whether this rank writes (the mesh's first rank, or any rank
        without a layout)."""
        if self.layout is None:
            return True
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_initialized() else 0
        return rank == self.layout.mesh.ranks[0]

    def _mesh_barrier(self):
        if self.layout is None:
            return
        from rlinf_tpu_torch.parallel import collectives as C

        mesh = self.layout.mesh
        C.all_reduce_(torch.zeros(1, device=torch.device(mesh.device_type)), "sum",
                      mesh.get_group(tuple(mesh.shape)))

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root_dir, f"global_step_{step}")

    def latest_step(self) -> Optional[int]:
        steps = []
        if not os.path.isdir(self.root_dir):
            return None
        for name in os.listdir(self.root_dir):
            m = re.fullmatch(r"global_step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.root_dir, name, "_DONE")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def save(self, step: int, state: Any, extra: Optional[Dict] = None):
        """Save the state tree and JSON-serializable extra state (dataloader
        position, rng seeds, config echo). With a layout every rank of its
        mesh calls this: the leaves are gathered whole, one rank writes."""
        flat = flatten(state)
        if self.layout is not None:
            from rlinf_tpu_torch.parallel.sharding import gather_block

            lay = self.layout
            flat = {k: gather_block(v, lay.spec_for(k, v.shape), lay.mesh).cpu()
                    if isinstance(v, torch.Tensor) else v for k, v in flat.items()}
        if not self._writer():
            self._mesh_barrier()
            return
        path = self._step_dir(step)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(flat, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        if extra is not None:
            with open(os.path.join(path, "extra.json"), "w") as f:
                json.dump(extra, f)
        with open(os.path.join(path, "_DONE"), "w") as f:
            f.write("ok")
        self._gc()
        self._mesh_barrier()

    def restore(self, state_template: Any, step: Optional[int] = None
                ) -> Tuple[Any, Optional[Dict], Optional[int]]:
        """Restore the latest (or the given) step in the template's
        structure and onto its devices. Raises where a leaf is missing or
        its shape, type or dtype differs from the template's (the
        optimizer state's floating leaves may come back wider)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None, None
        path = self._step_dir(step)
        device = next((t.device for t in flatten(state_template).values()
                       if isinstance(t, torch.Tensor)), "cpu")
        flat = torch.load(os.path.join(path, STATE_FILE), map_location=device,
                          weights_only=True)
        block = None
        if self.layout is not None:
            from rlinf_tpu_torch.parallel.sharding import local_block

            lay = self.layout
            block = lambda k, t: local_block(t, lay.full_spec(k, t), lay.mesh).contiguous()
        state = _rebuild(state_template, "", flat, block=block)
        extra = None
        extra_path = os.path.join(path, "extra.json")
        if os.path.exists(extra_path):
            with open(extra_path) as f:
                extra = json.load(f)
        return state, extra, step

    def _gc(self):
        steps = sorted(
            int(m.group(1))
            for name in os.listdir(self.root_dir)
            if (m := re.fullmatch(r"global_step_(\d+)", name))
        )
        for s in steps[: -self.max_to_keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
