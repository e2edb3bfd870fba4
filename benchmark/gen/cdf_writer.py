"""A single-file CDF V3.7 writer: z-variables stored as GZIP-compressed blocks of records.

A copy of the subset of ``configurable_spectrograms_torch/data/cdf/writer.py``
that the benchmark's archives need (row-major V3, per-variable GZIP, global
string attributes), with the deflate level as an argument and a variable's
records in one or more compressed blocks, each an entry of its index record
(as CDF files with a blocking factor hold them).  The benchmark writes at
level 1: inflating costs the same at any level, so the decode the window
measures is unchanged.  The GZIP header carries no time stamp, so one seed
always gives the same bytes.
"""

from __future__ import annotations

import gzip
import struct
from typing import NamedTuple

import numpy as np

_IBMPC = 6  # little-endian variable data
_CDF_TYPES = {"int16": 2, "int32": 4, "float32": 21, "float64": 22}
_NAME_LEN = 256


class Blocks(NamedTuple):
    """A variable given as compressed record blocks: ``blocks`` is [(first, last, gzip bytes), ...]."""

    dtype: str
    shape: tuple[int, ...]
    blocks: list[tuple[int, int, bytes]]


def compress(rows: np.ndarray, level: int) -> bytes:
    """One block's GZIP stream: the records' little-endian bytes, row-major."""
    return gzip.compress(np.ascontiguousarray(rows, rows.dtype.newbyteorder("<")).tobytes(),
                         compresslevel=level, mtime=0)


def _off(value: int) -> bytes:
    return struct.pack(">q", value)


def _name(text: str) -> bytes:
    raw = text.encode("latin-1")[:_NAME_LEN]
    return raw + b"\x00" * (_NAME_LEN - len(raw))


def _record(rtype: int, body: bytes) -> bytes:
    return _off(12 + len(body)) + struct.pack(">i", rtype) + body


class _Builder:
    """Records in file order, with offset fields patched once their targets are placed."""

    def __init__(self) -> None:
        self.chunks: list[bytes] = []
        self.pos = 0

    def add(self, data: bytes) -> int:
        at = self.pos
        self.chunks.append(data)
        self.pos += len(data)
        return at

    def patch(self, index: int, body_pos: int, value: int, fmt: str = ">q") -> None:
        c = bytearray(self.chunks[index])
        struct.pack_into(fmt, c, 12 + body_pos, value)
        self.chunks[index] = bytes(c)


def write_cdf(path: str, variables: dict[str, "np.ndarray | Blocks"], global_attrs: dict[str, str] | None = None,
              level: int = 1) -> int:
    """Write *variables* (axis 0 the record axis; arrays, or :class:`Blocks`) to *path*; returns the bytes."""
    b = _Builder()
    b.add(struct.pack(">II", 0xCDF30001, 0x0000FFFF))
    cdr = _off(0) + struct.pack(">iiii", 3, 7, _IBMPC, 0x2 | 0x1) + struct.pack(">iiiii", 0, 0, 0, 3, 0)
    cdr_index = len(b.chunks)
    b.add(_record(1, cdr + b"\x00" * 256))

    names = list(variables)
    gdr = _off(0) + _off(0) + _off(0) + _off(0) + struct.pack(">ii", 0, 0) + struct.pack(">ii", -1, 0)
    gdr += struct.pack(">i", len(names)) + _off(0) + struct.pack(">iii", 0, 0, 0)
    gdr_index = len(b.chunks)
    b.patch(cdr_index, 0, b.add(_record(2, gdr)))

    zvdr_head, prev = 0, None
    for num, name in enumerate(names):
        var = variables[name]
        if not isinstance(var, Blocks):
            arr = np.asarray(var)
            var = Blocks(arr.dtype.name, arr.shape, [(0, arr.shape[0] - 1, compress(arr, level))])
        n_rec, dims = int(var.shape[0]), tuple(int(s) for s in var.shape[1:])
        vdr = _off(0) + struct.pack(">ii", _CDF_TYPES[var.dtype], n_rec - 1) + _off(0) + _off(0)
        vdr += struct.pack(">ii", 0x1 | 0x4, 0) + struct.pack(">iii", 0, 0, -1) + struct.pack(">ii", 1, num)
        vdr += _off(0) + struct.pack(">i", n_rec) + _name(name) + struct.pack(">i", len(dims))
        vdr += b"".join(struct.pack(">i", d) for d in dims) + struct.pack(">i", -1) * len(dims)
        vdr_index = len(b.chunks)
        vdr_off = b.add(_record(8, vdr))
        if prev is None:
            zvdr_head = vdr_off
        else:
            b.patch(prev, 0, vdr_off)
        prev = vdr_index
        b.patch(vdr_index, 60, b.add(_record(11, struct.pack(">iiii", 5, 0, 1, level))))  # CPR: GZIP
        entries = [(first, last, b.add(_record(13, struct.pack(">i", 0) + _off(len(cdata)) + cdata)))
                   for first, last, cdata in var.blocks]
        n = len(entries)
        vxr = _off(0) + struct.pack(">ii", n, n) + b"".join(struct.pack(">i", e[0]) for e in entries)
        vxr += b"".join(struct.pack(">i", e[1]) for e in entries) + b"".join(_off(e[2]) for e in entries)
        vxr_off = b.add(_record(6, vxr))
        b.patch(vdr_index, 16, vxr_off)
        b.patch(vdr_index, 24, vxr_off)

    adr_head, prev = 0, None
    attrs = dict(global_attrs or {})
    for attr_num, (aname, avalue) in enumerate(attrs.items()):
        adr = _off(0) + _off(0) + struct.pack(">ii", 1, attr_num) + struct.pack(">iii", 1, 0, 0) + _off(0)
        adr += struct.pack(">iii", 0, -1, 0) + _name(aname)
        adr_index = len(b.chunks)
        adr_off = b.add(_record(4, adr))
        if prev is None:
            adr_head = adr_off
        else:
            b.patch(prev, 0, adr_off)
        prev = adr_index
        raw = str(avalue).encode("latin-1")
        aedr = _off(0) + struct.pack(">ii", attr_num, 51) + struct.pack(">ii", 0, max(1, len(raw)))
        aedr += struct.pack(">iiiii", 0, 0, 0, 0, 0) + raw
        b.patch(adr_index, 8, b.add(_record(5, aedr)))

    b.patch(gdr_index, 8, zvdr_head)
    b.patch(gdr_index, 16, adr_head)
    b.patch(gdr_index, 24, b.pos)
    b.patch(gdr_index, 36, len(attrs), ">i")
    blob = b"".join(b.chunks)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)
