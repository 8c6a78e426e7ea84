"""Hugging Face checkpoint files, read and written with the standard library,
numpy and torch.

A safetensors file is an 8-byte little-endian header length, a JSON header
(``{name: {"dtype", "shape", "data_offsets"}, "__metadata__": {...}}``) and
the raw little-endian tensor data; offsets count from the end of the
header. ``read_safetensors`` reads F32, F16 and BF16 tensors and raises on
any other dtype; ``write_safetensors`` pads the header with spaces to a
multiple of 8 bytes, as the ``safetensors`` package does. A checkpoint
directory holds ``model.safetensors``, shards listed by
``model.safetensors.index.json``, ``pytorch_model.bin`` (read with
``torch.load(weights_only=True)``) or shards listed by
``pytorch_model.bin.index.json``; ``load_state_dict`` reads whichever it
finds first in that order.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping, Optional

import torch

#: safetensors dtype names of the floating types a checkpoint may hold
_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_NAMES = {v: k for k, v in _DTYPES.items()}


def read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of one safetensors file, on the CPU, in the file's
    dtypes. The tensors are copies: the file is not held open."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    try:
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dt = _DTYPES.get(info["dtype"])
            if dt is None:
                raise ValueError(
                    f"{path}: tensor {name!r} has safetensors dtype {info['dtype']!r}; "
                    f"only {sorted(_DTYPES)} are read")
            start, end = info["data_offsets"]
            shape = tuple(info["shape"])
            count = end - start
            itemsize = torch.empty((), dtype=dt).element_size()
            numel = 1
            for s in shape:
                numel *= s
            if count != numel * itemsize:
                raise ValueError(f"{path}: tensor {name!r} spans {count} bytes, "
                                 f"its shape {shape} needs {numel * itemsize}")
            if numel == 0:
                out[name] = torch.empty(shape, dtype=dt)
                continue
            out[name] = torch.frombuffer(
                buf, dtype=dt, count=numel, offset=base + start).reshape(shape).clone()
    finally:
        buf.close()
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (F32, F16 or BF16) as one safetensors file."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} is not written "
                             f"(only {sorted(_NAMES.values())})")
        data = t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    if metadata is not None:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for b in blobs:
            f.write(b)


def _shards(path: str, index_name: str):
    index = read_json(os.path.join(path, index_name))
    return sorted(set(index["weight_map"].values()))


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint directory, on the CPU, in the files'
    dtypes."""
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return read_safetensors(single)
    if os.path.exists(os.path.join(path, "model.safetensors.index.json")):
        sd = {}
        for shard in _shards(path, "model.safetensors.index.json"):
            sd.update(read_safetensors(os.path.join(path, shard)))
        return sd
    files = []
    if os.path.exists(os.path.join(path, "pytorch_model.bin")):
        files = ["pytorch_model.bin"]
    elif os.path.exists(os.path.join(path, "pytorch_model.bin.index.json")):
        files = _shards(path, "pytorch_model.bin.index.json")
    if not files:
        raise FileNotFoundError(
            f"{path}: no model.safetensors, model.safetensors.index.json, "
            "pytorch_model.bin or pytorch_model.bin.index.json")
    sd = {}
    for name in files:
        sd.update(torch.load(os.path.join(path, name), map_location="cpu", weights_only=True))
    return sd
