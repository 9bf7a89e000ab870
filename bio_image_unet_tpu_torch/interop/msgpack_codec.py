"""msgpack as the JAX package's checkpoints use it, on ``struct`` and numpy
alone (counterpart of what ``bio_image_unet_tpu/checkpoint.py:61-65`` and
``:151`` reach through ``flax.serialization.msgpack_serialize`` /
``msgpack_restore``).

The format subset flax writes: nil, bool, positive and negative fixint,
(u)int 8–64, float 32/64, fixstr/str8/16/32, bin8/16/32,
fixarray/array16/32, fixmap/map16/map32 and fixext/ext8/16/32.  On top of it
flax's extension types (``flax.serialization._MsgpackExtType``):

- 1 ``ndarray``: a nested msgpack of ``(shape, dtype name, C-order bytes)``;
- 2 ``native_complex``: a nested msgpack of ``(real, imag)``;
- 3 ``npscalar``: an ``ndarray`` payload of a 0-d array, decoded to its
  scalar;

and the chunked-array dicts (``{'__msgpack_chunked_array__': True, 'shape':
{'0': …}, 'chunks': {'0': …}}``) flax writes for arrays above
``MAX_CHUNK_SIZE`` bytes.  A ``bfloat16`` array decodes to a
``torch.bfloat16`` tensor (numpy has no bfloat16 of its own); every other
dtype to a numpy array.

:func:`unpackb` / :func:`restore` raise ``ValueError`` on truncated or
corrupt input, and nothing else.  :func:`packb` writes the smallest encoding
of each int, as msgpack-python does, so :func:`serialize` of a tree gives
the bytes ``flax.serialization.msgpack_serialize`` gives.
"""

from __future__ import annotations

import struct
from collections import namedtuple
from typing import Any

import numpy as np
import torch

__all__ = ["ExtType", "MAX_CHUNK_SIZE", "packb", "unpackb", "serialize", "restore"]

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are written in chunks
MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# an extension value of a code the codec does not interpret (msgpack's own
# ``ExtType`` is the same named tuple, so the two compare equal)
ExtType = namedtuple("ExtType", "code data")


class _Corrupt(ValueError):
    pass


# --- decoding -----------------------------------------------------------------


class _Reader:
    """One pass over ``buf`` (a writable ``memoryview``, so that arrays can
    share its memory); ``views`` hands bin payloads out as views, not
    copies."""

    def __init__(self, buf: memoryview, views: bool = False):
        self.buf, self.pos, self.views = buf, 0, views

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if n < 0 or end > len(self.buf):
            raise _Corrupt(f"truncated msgpack: {n} bytes wanted at offset {self.pos}, "
                           f"{len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError as err:
            raise _Corrupt(f"msgpack str is not UTF-8: {err}") from None

    def bin_(self, n: int):
        data = self.take(n)
        return data if self.views else bytes(data)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise _Corrupt(f"msgpack map key of type {type(key).__name__} "
                               "(only str and bytes are taken)")
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext_value(code, self.take(n))

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        op = _OPS.get(b)
        if op is None:
            raise _Corrupt(f"msgpack type byte 0x{b:02x} at offset {self.pos - 1} is not valid")
        return op(self)


_OPS = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: r.bin_(r.unpack(">B")),
    0xC5: lambda r: r.bin_(r.unpack(">H")),
    0xC6: lambda r: r.bin_(r.unpack(">I")),
    0xC7: lambda r: r.ext(r.unpack(">B")),
    0xC8: lambda r: r.ext(r.unpack(">H")),
    0xC9: lambda r: r.ext(r.unpack(">I")),
    0xCA: lambda r: r.unpack(">f"),
    0xCB: lambda r: r.unpack(">d"),
    0xCC: lambda r: r.unpack(">B"),
    0xCD: lambda r: r.unpack(">H"),
    0xCE: lambda r: r.unpack(">I"),
    0xCF: lambda r: r.unpack(">Q"),
    0xD0: lambda r: r.unpack(">b"),
    0xD1: lambda r: r.unpack(">h"),
    0xD2: lambda r: r.unpack(">i"),
    0xD3: lambda r: r.unpack(">q"),
    0xD4: lambda r: r.ext(1),
    0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: r.str_(r.unpack(">B")),
    0xDA: lambda r: r.str_(r.unpack(">H")),
    0xDB: lambda r: r.str_(r.unpack(">I")),
    0xDC: lambda r: r.array(r.unpack(">H")),
    0xDD: lambda r: r.array(r.unpack(">I")),
    0xDE: lambda r: r.map(r.unpack(">H")),
    0xDF: lambda r: r.map(r.unpack(">I")),
}


def _whole(reader: _Reader):
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise _Corrupt(f"{len(reader.buf) - reader.pos} bytes of extra data after the "
                       "msgpack value")
    return out


def _array_from(payload: memoryview):
    """An ``ndarray`` extension's payload → numpy array, or a
    ``torch.bfloat16`` tensor; shares ``payload``'s memory."""
    parts = _whole(_Reader(payload, views=True))
    if not (isinstance(parts, list) and len(parts) == 3):
        raise _Corrupt("an ndarray payload is not a (shape, dtype, bytes) triple")
    shape, name, data = parts
    if isinstance(name, memoryview):
        name = bytes(name)
    if isinstance(name, bytes):
        try:
            name = name.decode("ascii")
        except UnicodeDecodeError:
            raise _Corrupt("an ndarray dtype name is not ASCII") from None
    if (not isinstance(shape, list) or not isinstance(name, str)
            or not isinstance(data, memoryview)
            or not all(isinstance(d, int) and not isinstance(d, bool) and d >= 0
                       for d in shape)):
        raise _Corrupt("an ndarray payload has the wrong field types")
    if name == "bfloat16":
        itemsize = 2
    else:
        try:
            dtype = np.dtype(name)
        except TypeError:
            raise _Corrupt(f"unknown ndarray dtype {name!r}") from None
        if dtype.hasobject or dtype.fields is not None:
            raise _Corrupt(f"ndarray dtype {name!r} is not a plain numeric type")
        itemsize = dtype.itemsize
    count = int(np.prod(shape, dtype=object))
    if count * itemsize != len(data):
        raise _Corrupt(f"ndarray of shape {shape} {name} needs {count * itemsize} bytes, "
                       f"the payload holds {len(data)}")
    if name == "bfloat16":
        if count == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(data, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=dtype).reshape(shape)


def _ext_value(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _array_from(payload)
    if code == EXT_NPSCALAR:
        arr = _array_from(payload)
        if arr.ndim != 0:
            raise _Corrupt(f"an npscalar payload holds an array of shape {tuple(arr.shape)}")
        return arr if isinstance(arr, torch.Tensor) else arr[()]
    if code == EXT_COMPLEX:
        pair = _whole(_Reader(payload))
        if not (isinstance(pair, list) and len(pair) == 2
                and all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in pair)):
            raise _Corrupt("a native_complex payload is not a (real, imag) pair")
        return complex(pair[0], pair[1])
    return ExtType(code, bytes(payload))


def _writable(data) -> memoryview:
    if isinstance(data, bytearray):
        return memoryview(data)
    if isinstance(data, memoryview) and not data.readonly:
        return data.cast("B")
    # one copy, which every array of the result then shares
    return memoryview(bytearray(data))


def unpackb(data) -> Any:
    """The msgpack value in ``data`` (bytes-like), flax's extension types
    decoded; ``ValueError`` on anything truncated or corrupt."""
    try:
        return _whole(_Reader(_writable(data)))
    except _Corrupt:
        raise
    except (RecursionError, MemoryError, OverflowError, struct.error) as err:
        raise ValueError(f"corrupt msgpack: {type(err).__name__}: {err}") from None


def _unchunk(d: dict):
    try:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        if any(isinstance(c, torch.Tensor) for c in chunks):
            flat = torch.cat([torch.as_tensor(c).reshape(-1) for c in chunks])
        else:
            flat = np.concatenate([np.asarray(c).reshape(-1) for c in chunks])
        return flat.reshape(shape)
    except (KeyError, TypeError, ValueError, RuntimeError, AttributeError) as err:
        raise ValueError(f"corrupt chunked array: {type(err).__name__}: {err}") from None


def _unchunk_tree(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_tree(v) for k, v in tree.items()}
    return tree


def restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: :func:`unpackb`, then every
    chunked-array dict joined back into its array."""
    return _unchunk_tree(unpackb(data))


# --- encoding -----------------------------------------------------------------


def _int(v: int, out: bytearray) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for limit, head, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                                 (0xFFFFFFFF, 0xCE, ">I"), (2 ** 64 - 1, 0xCF, ">Q")):
            if v <= limit:
                out.append(head)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} does not fit msgpack's 64 bits")
    else:
        for limit, head, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"), (-2 ** 63, 0xD3, ">q")):
            if v >= limit:
                out.append(head)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int {v} does not fit msgpack's 64 bits")


def _header(n: int, out: bytearray, fix, small, heads) -> None:
    """A length header: ``fix`` (base, limit) for the fix form if it has
    one, ``small`` the 8-bit form's byte if it has one, then the 16- and
    32-bit forms."""
    if fix is not None and n <= fix[1]:
        out.append(fix[0] | n)
    elif small is not None and n <= 0xFF:
        out += bytes((small, n))
    elif n <= 0xFFFF:
        out.append(heads[0])
        out += struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out.append(heads[1])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"a msgpack object of {n} items or bytes is too large")


def _ext(code: int, payload: bytes, out: bytearray) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fixed is not None:
        out.append(fixed)
    else:
        _header(n, out, None, 0xC7, (0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += payload


def _array_bytes(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name,
    C-order bytes); a torch tensor is written as its numpy twin, bfloat16 by
    its raw 16-bit words."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return packb([list(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()])
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes cannot be written")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _int(obj, out)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _header(len(data), out, (0xA0, 31), 0xD9, (0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(len(data), out, None, 0xC4, (0xC5, 0xC6))
        out += data
    elif type(obj) in (list, tuple):
        _header(len(obj), out, (0x90, 15), None, (0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _header(len(obj), out, (0x80, 15), None, (0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _ext(EXT_NDARRAY, _array_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _ext(EXT_NPSCALAR, _array_bytes(np.asarray(obj)), out)
    elif type(obj) is complex:
        _ext(EXT_COMPLEX, packb([obj.real, obj.imag]), out)
    else:
        raise TypeError(f"cannot write {type(obj).__name__} as msgpack")


def packb(obj) -> bytes:
    """``obj`` (None, bool, int, float, str, bytes, list/tuple, dict, numpy
    arrays and scalars, torch tensors, complex) as msgpack, flax's extension
    types for the arrays, scalars and complex numbers."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _itemsize(arr) -> int:
    return arr.element_size() if isinstance(arr, torch.Tensor) else arr.dtype.itemsize


def _chunk(arr) -> dict:
    """flax's ``_chunk``: the flat array in runs of MAX_CHUNK_SIZE bytes."""
    flat = arr.reshape(-1)
    step = max(1, int(MAX_CHUNK_SIZE / _itemsize(arr)))
    chunks = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_tree(tree):
    if isinstance(tree, dict):
        # flax copies the tree with jax.tree_util first, which sorts dict keys
        return {k: _chunk_tree(tree[k]) for k in sorted(tree)}
    if (isinstance(tree, (np.ndarray, torch.Tensor))
            and int(np.prod(tree.shape)) * _itemsize(tree) > MAX_CHUNK_SIZE):
        return _chunk(tree)
    return tree


def serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize``: every dict's keys sorted,
    arrays above :data:`MAX_CHUNK_SIZE` bytes in chunks, then
    :func:`packb`."""
    return packb(_chunk_tree(tree))
