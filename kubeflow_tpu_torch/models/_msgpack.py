"""The msgpack form of ``flax.serialization.msgpack_serialize`` and
``msgpack_restore``, in pure Python over numpy and torch (no ``msgpack``
package).

What is written and read:

- maps with str keys (written in sorted key order, as flax writes them),
  arrays, nil, bools, ints, floats, str and bin, in msgpack's smallest
  encodings (as ``msgpack.packb`` chooses them);
- ext type 1, an ndarray: its payload is the msgpack array ``(shape, dtype
  name, raw C-order bytes)``; ext type 3, a numpy scalar, packed the same
  way as a 0-d array;
- ``bfloat16`` leaves, which numpy cannot hold: they are written from and
  read into ``torch.bfloat16`` tensors;
- flax's chunked form of a leaf over ``MAX_CHUNK_SIZE`` bytes, a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
  {"0": flat chunk, ...}}``, on write and on read.

``dump`` streams each leaf's bytes into the file, so a snapshot of several
GB is never built in memory. ``Stacked`` is a leaf that is the stack of
equal tensors along a new first axis, written from its parts without
stacking them (the port's per-layer tensors as the reference's scan-stacked
leaf). ``load`` reads the file once into a buffer (in pieces, in
parallel); the arrays it returns
are views of that buffer, a chunked leaf's too (its chunks are moved
together in place), so a snapshot's load holds one copy of its bytes.
"""

from __future__ import annotations

import ctypes
import io
import os
import struct
from typing import Any

import numpy as np
import torch

#: flax.serialization.MAX_CHUNK_SIZE: a leaf over this many bytes is chunked
MAX_CHUNK_SIZE = 2**30

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

_TORCH_NAMES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}


class Stacked:
    """``np.stack(parts)`` as a leaf, never materialised on write: the
    parts (torch tensors or numpy arrays of one shape and dtype) are
    written one after another, which is the stacked array's C order."""

    def __init__(self, parts: list):
        if not parts:
            raise ValueError("Stacked needs at least one part")
        self.parts = list(parts)

    def materialize(self) -> np.ndarray | torch.Tensor:
        if isinstance(self.parts[0], torch.Tensor):
            return torch.stack([p.detach().cpu() for p in self.parts])
        return np.stack([np.asarray(p) for p in self.parts])


# -- leaves -----------------------------------------------------------------


def _leaf_parts(x) -> tuple[tuple[int, ...], str, list[np.ndarray]]:
    """(shape, dtype name, byte buffers in C order) of an array leaf."""
    if isinstance(x, Stacked):
        shapes = {tuple(p.shape) for p in x.parts}
        if len(shapes) != 1:
            raise ValueError(f"Stacked parts differ in shape: {shapes}")
        names = set()
        bufs = []
        for p in x.parts:
            _, name, b = _leaf_parts(p)
            names.add(name)
            bufs.extend(b)
        if len(names) != 1:
            raise ValueError(f"Stacked parts differ in dtype: {names}")
        return (len(x.parts), *shapes.pop()), names.pop(), bufs
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _TORCH_NAMES:
            raise TypeError(f"unsupported tensor dtype {t.dtype}")
        name = _TORCH_NAMES[t.dtype]
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return tuple(t.shape), name, [raw.numpy().reshape(-1).view(np.uint8)]
    arr = np.asarray(x)
    if not arr.flags.c_contiguous:  # (ascontiguousarray makes 0-d 1-d)
        arr = np.ascontiguousarray(arr)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return arr.shape, arr.dtype.name, [arr.reshape(-1).view(np.uint8)]


def _nbytes(x) -> int:
    if isinstance(x, Stacked):
        return sum(_nbytes(p) for p in x.parts)
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor, Stacked))


def _chunk(x) -> dict:
    """flax's ``_chunk``: the canonical dict of flat chunks."""
    if isinstance(x, Stacked):
        x = x.materialize()
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else x.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


# -- writer -----------------------------------------------------------------


def _head_int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)),
                               (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)),
                               (0xd3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _head_len(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """A length header: the fix form under ``fix_max``, else the first of
    ``codes`` ((code, struct fmt, limit), ...) that holds ``n``."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack")


def _head_str(n: int) -> bytes:
    return _head_len(n, 0xa0, 32, ((0xd9, ">B", 1 << 8),
                                   (0xda, ">H", 1 << 16),
                                   (0xdb, ">I", 1 << 32)))


def _head_bin(n: int) -> bytes:
    return _head_len(n, None, 0, ((0xc4, ">B", 1 << 8),
                                  (0xc5, ">H", 1 << 16),
                                  (0xc6, ">I", 1 << 32)))


def _head_array(n: int) -> bytes:
    return _head_len(n, 0x90, 16, ((0xdc, ">H", 1 << 16),
                                   (0xdd, ">I", 1 << 32)))


def _head_map(n: int) -> bytes:
    return _head_len(n, 0x80, 16, ((0xde, ">H", 1 << 16),
                                   (0xdf, ">I", 1 << 32)))


def _head_ext(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return bytes([fixed[n], code])
    for c, fmt, top in ((0xc7, ">B", 1 << 8), (0xc8, ">H", 1 << 16),
                        (0xc9, ">I", 1 << 32)):
        if n < top:
            return bytes([c]) + struct.pack(fmt, n) + bytes([code])
    raise OverflowError(f"ext payload of {n} bytes does not fit msgpack")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _head_str(len(raw)) + raw


def _write_array_ext(f, x, code: int) -> None:
    shape, name, bufs = _leaf_parts(x)
    n = sum(b.nbytes for b in bufs)
    inner = (_head_array(3) + _head_array(len(shape))
             + b"".join(_head_int(int(d)) for d in shape)
             + _str(name) + _head_bin(n))
    f.write(_head_ext(code, len(inner) + n))
    f.write(inner)
    for b in bufs:
        f.write(memoryview(b))


def _write(f, x, in_order: bool = False) -> None:
    if isinstance(x, dict):
        # flax maps the tree with jax.tree_util first, which sorts dict
        # keys; a chunk dict is built after that, in insertion order
        in_order = in_order or CHUNKED in x
        f.write(_head_map(len(x)))
        for k, v in (x.items() if in_order else sorted(x.items())):
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, not {type(k)}")
            f.write(_str(k))
            if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            _write(f, v, in_order)
    elif _is_array(x):
        _write_array_ext(f, x, EXT_NDARRAY)
    elif isinstance(x, np.generic):
        _write_array_ext(f, np.asarray(x), EXT_NPSCALAR)
    elif x is None:
        f.write(b"\xc0")
    elif isinstance(x, bool):
        f.write(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        f.write(_head_int(x))
    elif isinstance(x, float):
        f.write(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        f.write(_str(x))
    elif isinstance(x, (bytes, bytearray, memoryview)):
        raw = bytes(x)
        f.write(_head_bin(len(raw)) + raw)
    elif isinstance(x, (list, tuple)):
        f.write(_head_array(len(x)))
        for v in x:
            _write(f, v, in_order)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def dump(tree: Any, f) -> None:
    """Write ``tree`` to the binary file ``f`` (top-level array leaves over
    ``MAX_CHUNK_SIZE`` are chunked too, as flax does)."""
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunk(tree)
    _write(f, tree)


def dumps(tree: Any) -> bytes:
    buf = io.BytesIO()
    dump(tree, buf)
    return buf.getvalue()


# -- reader -----------------------------------------------------------------


def _array_from_payload(payload: memoryview):
    (shape, name, raw), end = _read(payload, 0)
    if end != len(payload):
        raise ValueError("trailing bytes in an ndarray payload")
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        if raw.readonly:  # torch takes only writable memory
            raw = bytearray(raw)
        flat = torch.from_numpy(np.frombuffer(raw, dtype=np.int16))
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _read(buf: memoryview, i: int):
    """(value, next offset) of the object at ``buf[i]``."""
    b = buf[i]
    i += 1
    if b < 0x80:
        return b, i
    if b >= 0xe0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8f:
        return _read_map(buf, i, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return _read_array(buf, i, b & 0x0f)
    if 0xa0 <= b <= 0xbf:
        n = b & 0x1f
        return str(buf[i:i + n], "utf-8"), i + n
    if b == 0xc0:
        return None, i
    if b == 0xc2:
        return False, i
    if b == 0xc3:
        return True, i
    fmt = _SCALARS.get(b)
    if fmt is not None:
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + size
    lens = _LENGTHS.get(b)
    if lens is not None:
        kind, fmt = lens
        size = struct.calcsize(fmt)
        n = struct.unpack_from(fmt, buf, i)[0]
        i += size
        if kind == "str":
            return str(buf[i:i + n], "utf-8"), i + n
        if kind == "bin":
            return buf[i:i + n], i + n
        if kind == "array":
            return _read_array(buf, i, n)
        if kind == "map":
            return _read_map(buf, i, n)
        return _read_ext(buf, i, n)
    if 0xd4 <= b <= 0xd8:
        return _read_ext(buf, i, 1 << (b - 0xd4))
    raise ValueError(f"unknown msgpack type byte 0x{b:02x}")


def _read_ext(buf: memoryview, i: int, n: int):
    code = struct.unpack_from(">b", buf, i)[0]
    payload = buf[i + 1:i + 1 + n]
    end = i + 1 + n
    if code == EXT_NDARRAY:
        return _array_from_payload(payload), end
    if code == EXT_NPSCALAR:
        arr = _array_from_payload(payload)
        return (arr if isinstance(arr, torch.Tensor) else arr[()]), end
    raise ValueError(f"unsupported msgpack ext type {code}")


def _read_array(buf: memoryview, i: int, n: int):
    out = []
    for _ in range(n):
        v, i = _read(buf, i)
        out.append(v)
    return out, i


def _read_map(buf: memoryview, i: int, n: int):
    out = {}
    for _ in range(n):
        k, i = _read(buf, i)
        v, i = _read(buf, i)
        out[k] = v
    return out, i


_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LENGTHS = {0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
            0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
            0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
            0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
            0xde: ("map", ">H"), 0xdf: ("map", ">I")}


def _address(x) -> int:
    return x.data_ptr() if isinstance(x, torch.Tensor) else x.ctypes.data


def _nbytes_of(x) -> int:
    return (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
            else x.nbytes)


def _join_in_place(chunks: list, buf: memoryview):
    """The chunks (views of ``buf``) as one flat array over ``buf``'s
    bytes, each moved down to the end of the one before it, or None where
    ``buf`` is read-only or the chunks do not lie in it one after another.
    A leaf's chunks are written in order with only msgpack headers between
    them, so a move overwrites only bytes already parsed, and no other
    leaf's."""
    if buf.readonly or not len(buf):
        return None
    base = np.frombuffer(buf, np.uint8)
    start = base.ctypes.data
    spans = [(_address(c) - start, _nbytes_of(c)) for c in chunks]
    at = spans[0][0]
    for off, n in spans:
        if off < at or off + n > base.nbytes:
            return None
        at += n
    at = spans[0][0]
    for off, n in spans:
        if off != at:
            ctypes.memmove(start + at, start + off, n)
        at += n
    flat = base[spans[0][0]:at]
    if isinstance(chunks[0], torch.Tensor):  # bfloat16
        return torch.from_numpy(flat.view(np.int16)).view(torch.bfloat16)
    return flat.view(chunks[0].dtype)


def _unchunk(tree, buf: memoryview):
    """flax's ``_unchunk_array_leaves_in_place``, returning the tree: a
    chunked leaf joined in ``buf`` (``_join_in_place``), else copied."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        joined = _join_in_place(chunks, buf)
        if joined is not None:
            return joined.reshape(shape)
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v, buf) for k, v in tree.items()}


def loads(data) -> Any:
    """The tree in ``data`` (bytes, bytearray or memoryview). Arrays are
    numpy views of ``data`` (writable when ``data`` is), ``bfloat16`` ones
    torch tensors; chunked leaves come back whole, views of ``data`` too
    when it is writable (their chunks moved together in it, so ``data``
    no longer holds the msgpack it held)."""
    buf = memoryview(data)
    tree, end = _read(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the tree")
    return _unchunk(tree, buf)


#: ``load`` reads a file in pieces of this many bytes on this many
#: threads: one ``readinto`` is bound by one core copying from the page
#: cache, which for a snapshot of several GB is seconds a load
READ_PIECE = 64 << 20
READ_THREADS = 8


def load(path: str) -> Any:
    """``loads`` of a file, read once into a writable buffer, its pieces
    read in parallel (``os.preadv`` on ``READ_THREADS`` threads)."""
    from concurrent.futures import ThreadPoolExecutor

    fd = os.open(path, os.O_RDONLY)
    try:
        size = os.fstat(fd).st_size
        data = bytearray(size)
        view = memoryview(data)

        def read(start: int) -> None:
            end, at = min(start + READ_PIECE, size), start
            while at < end:
                n = os.preadv(fd, [view[at:end]], at)
                if not n:
                    raise OSError(f"{path}: short read at {at} of {size} "
                                  "bytes")
                at += n

        with ThreadPoolExecutor(READ_THREADS) as pool:
            for _ in pool.map(read, range(0, size, READ_PIECE)):
                pass
    finally:
        os.close(fd)
    return loads(data)


def save(path: str, tree: Any) -> None:
    with open(path, "wb") as f:
        dump(tree, f)
