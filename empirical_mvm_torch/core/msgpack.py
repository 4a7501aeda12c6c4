"""The msgpack subset that the JAX package's checkpoints use, in pure Python
(counterpart of what ``flax.serialization`` does for
``empirical_mvm_tpu/train/checkpoint.py``).

Covers nil, bool, int, float, str, bin, array, map and ext. Two ext types
carry arrays, as flax writes them: 1 (an ndarray) and 3 (a numpy scalar),
each a nested msgpack ``(shape, dtype name, C-order bytes)``. An array of
more than :data:`MAX_CHUNK_SIZE` bytes is written, and read, in flax's
chunked form ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
"chunks": {"0": flat part, ...}}``. Any other type code raises.

numpy has no bfloat16: such a leaf comes back as a ``torch.bfloat16``
tensor (its bytes read through an int16 view), and a bfloat16 tensor is
written under the dtype name ``bfloat16``, as flax writes ``jnp.bfloat16``.
Every other array comes back as a numpy array over the input buffer (no
copy; writable when the input is a ``bytearray``), and a tensor of any
other dtype is written through ``.numpy()``.

:func:`packb` writes what ``flax.serialization.msgpack_restore`` reads;
:func:`unpackb` reads flax's ``to_bytes`` output as ``msgpack_restore``
gives it (nested dicts of str keys). Encodings are the shortest, as
``msgpack.packb`` chooses them, and floats are float64.
"""

from __future__ import annotations

import struct
from typing import Any, Callable

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"
# flax's limit: msgpack holds at most 2**31 - 1 bytes an object
MAX_CHUNK_SIZE = 2 ** 30


class MsgpackError(ValueError):
    pass


# ---------------------------------------------------------------- writing

def _head(write: Callable[[bytes], Any], n: int, fix: int | None, fix_max: int,
          codes: tuple[int, int, int]) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32 bits
    (``codes``; 0 where the type has no 8-bit form)."""
    if fix is not None and n < fix_max:
        write(bytes((fix | n,)))
    elif codes[0] and n <= 0xFF:
        write(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        write(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        write(struct.pack(">BI", codes[2], n))
    else:
        raise MsgpackError(f"an object of {n} bytes or items is too large for msgpack")


def _int(write, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        write(struct.pack(">b" if v < 0 else ">B", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                               (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", 2 ** 64 - 1)):
            if v <= top:
                write(struct.pack(fmt, code, v))
                return
        raise MsgpackError(f"integer {v} does not fit 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -2 ** 7), (0xD1, ">Bh", -2 ** 15),
                               (0xD2, ">Bi", -2 ** 31), (0xD3, ">Bq", -2 ** 63)):
            if v >= low:
                write(struct.pack(fmt, code, v))
                return
        raise MsgpackError(f"integer {v} does not fit 64 bits")


def _ext(write, code: int, payload_parts: list) -> None:
    n = sum(len(p) for p in payload_parts)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        write(struct.pack(">Bb", fixed[n], code))
    elif n <= 0xFF:
        write(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        write(struct.pack(">BHb", 0xC8, n, code))
    elif n <= 0xFFFFFFFF:
        write(struct.pack(">BIb", 0xC9, n, code))
    else:
        raise MsgpackError(f"an ext of {n} bytes is too large for msgpack")
    for p in payload_parts:
        write(p)


def _array_parts(x) -> tuple[tuple[int, ...], str, memoryview]:
    """(shape, dtype name, C-order bytes) of an array or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), "bfloat16", memoryview(x.view(torch.int16).numpy()).cast("B")
        x = x.numpy()
    x = np.asarray(x)
    x = x if x.flags.c_contiguous else x.copy(order="C")    # keeps a 0-d shape
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise MsgpackError("object and structured dtypes are not serialised")
    # ml_dtypes' bfloat16 (a JAX array through np.asarray) names itself so
    return x.shape, x.dtype.name, memoryview(x.reshape(-1).view(np.uint8))


def _ndarray_payload(x) -> list:
    shape, name, data = _array_parts(x)
    head: list[bytes] = []
    w = head.append
    w(b"\x93")                                  # fixarray of 3
    _head(w, len(shape), 0x90, 16, (0, 0xDC, 0xDD))
    for d in shape:
        _int(w, int(d))
    enc = name.encode()
    _head(w, len(enc), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    w(enc)
    _head(w, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    return [b"".join(head), data]


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """flax's ``_chunk``: the flat array in parts of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def pack(obj: Any, write: Callable[[bytes], Any], *, _root: bool = True) -> None:
    """Write ``obj`` through ``write`` (a file's ``write``, a list's
    ``append``)."""
    if _root and isinstance(obj, (np.ndarray, torch.Tensor)) and _nbytes(obj) > MAX_CHUNK_SIZE:
        obj = _chunk(obj)
    if obj is None:
        write(b"\xc0")
    elif obj is True:
        write(b"\xc3")
    elif obj is False:
        write(b"\xc2")
    elif isinstance(obj, int) and not isinstance(obj, np.generic):
        _int(write, obj)
    elif isinstance(obj, float) and not isinstance(obj, np.generic):
        write(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        enc = obj.encode()
        _head(write, len(enc), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        write(enc)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        _head(write, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        write(data)
    elif isinstance(obj, dict):
        _head(write, len(obj), 0x80, 16, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            pack(k, write, _root=False)
            if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            pack(v, write, _root=False)
    elif isinstance(obj, (list, tuple)):
        _head(write, len(obj), 0x90, 16, (0, 0xDC, 0xDD))
        for v in obj:
            pack(v, write, _root=False)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _ext(write, EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _ext(write, EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    else:
        raise MsgpackError(f"cannot serialise {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    parts: list = []
    pack(obj, parts.append)
    return b"".join(parts)


# ---------------------------------------------------------------- reading

class _Reader:
    def __init__(self, data, bin_view: bool = False):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.bin_view = bin_view       # bin as a view of the buffer, not bytes

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise MsgpackError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, raw)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fmts = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fmts:
            return self.unpack(fmts[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H",
                0xC9: ">I"}
        if b in (0xC4, 0xC5, 0xC6):
            data = self.take(self.unpack(lens[b]))
            return data if self.bin_view else bytes(data)
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack(lens[b]), raw)
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(lens[b]), raw)
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(lens[b]), raw)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack(lens[b]))
        raise MsgpackError(f"msgpack type byte 0x{b:02x} is not in the subset read here")

    def str(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def array(self, n: int, raw: bool) -> list:
        return [self.obj(raw) for _ in range(n)]

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise MsgpackError(f"msgpack ext type {code} is not an array")
        arr = _array_from_payload(payload)
        return arr if code == EXT_NDARRAY else arr[()]


def _array_from_payload(payload: memoryview):
    shape, name, data = _Reader(payload, bin_view=True).obj(raw=True)
    name = name.decode()
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        t = torch.frombuffer(data, dtype=torch.int16) if len(data) else torch.empty(
            0, dtype=torch.int16)
        return t.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            parts = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if isinstance(parts[0], torch.Tensor):
                return torch.cat(parts).reshape(shape)
            return np.concatenate(parts).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data) -> Any:
    """The object that ``data`` holds; chunked arrays joined. A
    ``bytearray`` gives writable numpy leaves."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return _unchunk(out)
