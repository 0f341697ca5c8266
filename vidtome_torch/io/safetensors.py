"""The safetensors file format, read and written without the ``safetensors``
package.

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}``, with an
optional ``"__metadata__"`` of strings), then the tensors' raw little-endian
bytes, each at its offsets from the end of the header.  :func:`load_file`
returns CPU tensors over one copy-on-write memory map of the file (pages
are read when a tensor is first touched, writes stay private);
:func:`save_file` writes a file that ``safetensors.torch.load_file`` reads.
"""

from __future__ import annotations

import json
import mmap
import os
import struct

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of the safetensors file at ``path``, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size
        data = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
                if size > 8 + n else bytearray())
    base = 8 + n
    header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}, which is not read here")
        dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        count = (end - begin) // dtype.itemsize
        if count == 0:
            t = torch.empty(0, dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, count=count,
                                 offset=base + begin)
        out[name] = t.reshape(info["shape"])
    return out


def save_file(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device, contiguous or not) to ``path``."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)  # the tensors start 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)
