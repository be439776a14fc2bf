"""The safetensors file format, read and written without its package.

A file is an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
header, then the tensors' raw little-endian bytes. The header maps each
tensor's name to ``{"dtype", "shape", "data_offsets": [begin, end]}``
(offsets counted from the end of the header) and may hold
``"__metadata__"``, a dict of strings. The writer pads the header with
spaces to a multiple of 8 bytes and stores the tensors widest element
first, then by name, as the ``safetensors`` package does, so every tensor
starts at a multiple of its element size.

The reader memory-maps a file's tensors one at a time and hands each out
as a view over its map (``torch.frombuffer``: no copy until the caller
converts it); ``release`` unmaps a tensor once it has been converted, so a
streaming loader's host memory stays near one tensor.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import warnings
from typing import Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["read_header", "SafetensorsFile", "save_file", "as_tensor"]

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "U8": torch.uint8, "I8": torch.int8,
    "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
    "BOOL": torch.bool, "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_NAMES = {dt: name for name, dt in DTYPES.items()}
_HEADER_LIMIT = 100 << 20  # the package's own bound on a header


def read_header(path: str):
    """(header dict without ``__metadata__``, metadata dict or None, byte
    offset of the data) of a safetensors file."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        (n,) = struct.unpack("<Q", raw)
        if n > _HEADER_LIMIT:
            raise ValueError(f"{path}: header of {n} bytes")
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None)
    return header, meta, 8 + n


class SafetensorsFile:
    """A read-only safetensors file (a context manager) that maps each
    tensor's bytes on demand.

    ``get_tensor(name)`` maps the pages that hold ``name`` and returns a
    CPU tensor viewing them (not writable; convert or clone it before
    writing). ``release(name)`` unmaps them once the caller has dropped
    that view, so a reader that releases each tensor after converting it
    holds about one tensor's pages: an unmapped page leaves the process's
    resident set on any kernel, where an madvise of a shared file mapping
    need not."""

    def __init__(self, path: str):
        self.path = path
        self.header, self.metadata, self._start = read_header(path)
        size = os.path.getsize(path)
        for name, info in self.header.items():
            begin, end = info["data_offsets"]
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has dtype {info['dtype']}")
            if not 0 <= begin <= end or self._start + end > size:
                raise ValueError(f"{path}: {name} lies outside the file")
        self._file = open(path, "rb")
        self._maps: Dict[str, mmap.mmap] = {}

    def keys(self):
        return list(self.header)

    def get_tensor(self, name: str) -> torch.Tensor:
        info = self.header[name]
        dtype, shape = DTYPES[info["dtype"]], info["shape"]
        begin, end = info["data_offsets"]
        n_bytes = end - begin
        if n_bytes != (int(np.prod(shape, dtype=np.int64))
                       * torch.empty((), dtype=dtype).element_size()):
            raise ValueError(f"{self.path}: {name} holds {n_bytes} bytes "
                             f"for shape {shape} of {info['dtype']}")
        if n_bytes == 0:
            return torch.empty(shape, dtype=dtype)
        first = self._start + begin
        skip = first % mmap.ALLOCATIONGRANULARITY  # a map starts aligned
        if name not in self._maps:
            self._maps[name] = mmap.mmap(self._file.fileno(), skip + n_bytes,
                                         access=mmap.ACCESS_READ,
                                         offset=first - skip)
        with warnings.catch_warnings():  # the map is read-only, by design
            warnings.simplefilter("ignore", UserWarning)
            raw = torch.frombuffer(self._maps[name], dtype=torch.uint8,
                                   count=n_bytes, offset=skip)
        return raw.view(dtype).reshape(shape)

    def release(self, name: str) -> None:
        """Unmap ``name``'s pages (a later ``get_tensor`` maps them again).
        A view of them still alive keeps them mapped until it dies."""
        m = self._maps.pop(name, None)
        if m is not None:
            _close(m)

    def close(self) -> None:
        for name in list(self._maps):
            self.release(name)
        self._file.close()

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _close(m: mmap.mmap) -> None:
    try:
        m.close()
    except BufferError:
        # a view handed out is still alive (an exception's frames may hold
        # one): the map closes when the last view dies
        pass


def as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor, without a copy where it can: a tensor as it is, a
    numpy array through ``torch.from_numpy`` (a bfloat16 array of ml_dtypes
    through its 16-bit pattern)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    arr = np.ascontiguousarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_file(tensors: Mapping[str, object], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (name -> tensor or numpy array) to ``path`` in the
    safetensors format, with ``metadata`` (strings) in the header."""
    items = sorted(((name, as_tensor(t).cpu().contiguous())
                    for name, t in tensors.items()),
                   key=lambda it: (-it[1].element_size(), it[0]))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors "
                            "name")
        n_bytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n_bytes]}
        offset += n_bytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)
