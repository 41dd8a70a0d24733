"""The subset of MessagePack that ``flax.serialization`` writes and reads
(``msgpack_serialize`` / ``msgpack_restore``), in numpy and torch alone, so
the port reads and writes the JAX package's checkpoint files.

Types: maps with str keys, arrays (from lists and tuples), str, bin, ints,
floats (always float64, as msgpack-python packs a Python float), bool and
nil. Two extension types carry arrays, as flax packs them:

- ext 1, an ndarray: the msgpack array ``(shape, dtype name, raw C-order
  bytes)``;
- ext 3, a numpy scalar: the same payload for a 0-d array.

A torch tensor or numpy array packs as ext 1, a numpy scalar as ext 3, and
both unpack as CPU torch tensors (a scalar as a 0-d one). numpy has no
bfloat16, so a ``"bfloat16"`` payload is read as int16 and viewed as
``torch.bfloat16``, and written the other way round. Like flax, an array
leaf over ``MAX_CHUNK_SIZE`` bytes is stored as a map of flat chunks
(``__msgpack_chunked_array__``), and such maps are joined back on read.

:func:`pack` hands the output to ``write`` piece by piece (array data as
memoryviews of the tensors' own bytes), so a file of a gigabyte or more is
written without ever being joined in memory.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization's limit per array leaf
_CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------- write --

def _uint_header(n: int, fix_base: int, fix_max: int, codes: Tuple) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    (8-, 16-, 32-bit) ``codes`` that holds n (None skips a width)."""
    if n < fix_max:
        return bytes([fix_base | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too large")


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF),
                                 (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= limit:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, limit in ((0xD0, ">b", 0x80), (0xD1, ">h", 0x8000),
                                 (0xD2, ">i", 0x80000000),
                                 (0xD3, ">q", 0x8000000000000000)):
            if -n <= limit:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit 64 bits")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _uint_header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _uint_header(n, 0, 0, (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _uint_header(n, 0, 0, (0xC7, 0xC8, 0xC9)) + bytes([code])


def _array_bytes(x) -> Tuple[Tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of a tensor, array or numpy
    scalar, the bytes a view where the layout allows."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        data = t.reshape(-1).numpy()
        return tuple(x.shape), name, memoryview(data).cast("B")
    a = np.asarray(x)
    if not a.flags.c_contiguous:  # ascontiguousarray would make 0-d 1-d
        a = a.copy(order="C")
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"cannot serialize an array of dtype {a.dtype}")
    return a.shape, a.dtype.name, memoryview(a.reshape(-1)).cast("B")


def _pack_array(x, code: int, write: Callable[[Any], Any]) -> None:
    shape, name, data = _array_bytes(x)
    head = (bytes([0x93]) + _uint_header(len(shape), 0x90, 16, (None, 0xDC,
                                                               0xDD))
            + b"".join(_int(d) for d in shape) + _str(name)
            + _bin_header(data.nbytes))
    write(_ext_header(code, len(head) + data.nbytes) + head)
    write(data)


def _chunked(x) -> dict:
    """flax's chunked form of an array leaf over MAX_CHUNK_SIZE bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) \
        else np.asarray(x).dtype.itemsize
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = x.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def pack(obj, write: Callable[[Any], Any]) -> None:
    """Serialize ``obj`` as flax's ``msgpack_serialize`` would, calling
    ``write`` with each piece (bytes or memoryview) in order."""
    if isinstance(obj, np.generic):  # before float: np.float64 is a float
        _pack_array(np.asarray(obj), EXT_NPSCALAR, write)
    elif obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, bool):
        write(_int(obj))
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        write(_str(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        write(_bin_header(data.nbytes))
        write(data)
    elif isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError(f"map keys must be str, got {list(obj)}")
        write(_uint_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for k in sorted(obj):  # flax's tree_map writes maps key-sorted
            write(_str(k))
            pack(obj[k], write)
    elif isinstance(obj, (list, tuple)):
        write(_uint_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in obj:
            pack(v, write)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            pack(_chunked(obj), write)
        else:
            _pack_array(obj, EXT_NDARRAY, write)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` serialized, as one bytes object."""
    parts: List = []
    pack(obj, parts.append)
    return b"".join(parts)


def dump(obj, f) -> None:
    """Serialize ``obj`` into the binary file ``f``."""
    pack(obj, f.write)


# ------------------------------------------------------------------ read --

class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fmt = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
               0xCA: ">f", 0xCB: ">d"}.get(b)
        if fmt:
            return self.unpack(fmt)
        size = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}.get(b)
        if b in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack(size))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack(size)), "utf-8")
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(size))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(size))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack(size)
            return self.ext(self.take(1)[0], n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.take(1)[0], 1 << (b - 0xD4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int):
        payload = _Reader(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, name, data = payload.obj()
        return _tensor(tuple(shape), name, data)


def _tensor(shape: Tuple[int, ...], name: str, data: memoryview
            ) -> torch.Tensor:
    """A CPU tensor owning a copy of ``data``."""
    bf16 = name == "bfloat16"
    a = np.frombuffer(data, dtype=np.int16 if bf16 else np.dtype(name))
    t = torch.from_numpy(a.copy().reshape(shape))
    return t.view(torch.bfloat16) if bf16 else t


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(buf) -> Any:
    """Deserialize one object from ``buf`` (bytes, bytearray or
    memoryview), as flax's ``msgpack_restore`` would; arrays come back as
    CPU torch tensors, bin as bytes."""
    r = _Reader(buf)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         f"object")
    return _bytes_out(_unchunk(out))


def _bytes_out(tree):
    if isinstance(tree, memoryview):
        return tree.tobytes()
    if isinstance(tree, dict):
        return {k: _bytes_out(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bytes_out(v) for v in tree]
    return tree


def load(path: str) -> Any:
    """Deserialize the file at ``path``."""
    with open(path, "rb") as f:
        buf = bytearray(f.seek(0, 2))
        f.seek(0)
        f.readinto(buf)
    return unpackb(buf)
