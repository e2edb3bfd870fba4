"""Writer for single-file CDF containers (synthetic fixtures and exports).

Produces spec-conformant CDF V3.7 -- or V2.7, whose 4-byte offsets and
64-byte name fields exercise the reader's legacy branch -- single-file
containers with z-variables, optional per-variable GZIP compression (CVVR),
optional whole-file compression (CCR), and global attributes.  Used by the
synthetic FAST fixture generator (the reference repo ships no data, so
tests and benchmarks generate their own CDFs) and round-trip tested against
:mod:`configurable_spectrograms_torch.data.cdf.reader`.
"""

from __future__ import annotations

import gzip
import struct
from typing import Any

import numpy as np

_ENCODING_IBMPC = 6  # little-endian variable data

_NP_TO_CDF: dict[str, int] = {
    "int8": 1,
    "int16": 2,
    "int32": 4,
    "int64": 8,
    "uint8": 11,
    "uint16": 12,
    "uint32": 14,
    "float32": 21,
    "float64": 22,
}


class _Format:
    """Byte-layout knobs that differ between CDF V3 and V2.6/2.7."""

    def __init__(self, version: int):
        if version == 3:
            self.magic1 = 0xCDF30001
            self.off_fmt = ">q"
            self.off_size = 8
            self.name_len = 256
            self.ver, self.rel = 3, 7
        elif version == 2:
            self.magic1 = 0xCDF26002
            self.off_fmt = ">i"
            self.off_size = 4
            self.name_len = 64
            self.ver, self.rel = 2, 7
        else:
            raise ValueError(f"unsupported CDF version {version}")
        self.header_len = self.off_size + 4  # RecordSize + RecordType

    def off(self, value: int) -> bytes:
        return struct.pack(self.off_fmt, value)

    def name(self, text: str) -> bytes:
        raw = text.encode("latin-1")[: self.name_len]
        return raw + b"\x00" * (self.name_len - len(raw))

    def record(self, rtype: int, body: bytes) -> bytes:
        return self.off(self.header_len + len(body)) + struct.pack(">i", rtype) + body


class _Builder:
    """Accumulates records, supporting later patching of offset fields."""

    def __init__(self, fmt: _Format) -> None:
        self.fmt = fmt
        self.chunks: list[bytes] = []
        self.pos = 0

    def add(self, data: bytes) -> int:
        at = self.pos
        self.chunks.append(data)
        self.pos += len(data)
        return at

    def patch_off(self, chunk_index: int, body_pos: int, value: int) -> None:
        """Overwrite an offset-sized field at *body_pos* within a record body."""
        c = bytearray(self.chunks[chunk_index])
        struct.pack_into(self.fmt.off_fmt, c, self.fmt.header_len + body_pos, value)
        self.chunks[chunk_index] = bytes(c)

    def patch_i4(self, chunk_index: int, body_pos: int, value: int) -> None:
        c = bytearray(self.chunks[chunk_index])
        struct.pack_into(">i", c, self.fmt.header_len + body_pos, value)
        self.chunks[chunk_index] = bytes(c)


def write_cdf(
    path: str,
    variables: dict[str, np.ndarray],
    global_attrs: dict[str, Any] | None = None,
    compress: str = "none",
    row_major: bool = True,
    version: int = 3,
    checksum: bool = False,
) -> str:
    """Write *variables* to a single-file CDF at *path*.

    Parameters
    ----------
    path : str
        Output file path.
    variables : dict of {str: numpy.ndarray}
        Variable name -> array; axis 0 is the record dimension, the
        remaining axes become the z-variable dimensions.
    global_attrs : dict or None
        Global attributes (str or scalar values).
    compress : {'none', 'gzip', 'file'}
        ``'gzip'`` compresses each variable's records into a CVVR;
        ``'file'`` wraps the whole container in a CCR.
    row_major : bool, default True
        Record-interior element order.
    version : {3, 2}, default 3
        Container format generation (2 = V2.7 legacy layout).
    checksum : bool, default False
        Append the spec's 16-byte MD5 signature (of the physical file
        content preceding it) and set the CDR checksum flags; readers
        opt in to verifying it via ``CDF(path, validate=True)``.

    Returns
    -------
    str
        The *path* written.
    """
    if compress not in ("none", "gzip", "file"):
        raise ValueError(f"unsupported compress mode {compress!r}")
    fmt = _Format(version)
    b = _Builder(fmt)
    b.add(struct.pack(">II", fmt.magic1, 0x0000FFFF))

    # --- CDR -----------------------------------------------------------------
    flags = 0x2 | (0x1 if row_major else 0x0)  # single-file (+ row-major)
    if checksum:
        flags |= 0x4 | 0x8  # checksum present, MD5 method
    cdr = bytearray()
    cdr_gdr_pos = len(cdr)
    cdr += fmt.off(0)  # GDRoffset (patched)
    cdr += struct.pack(">iiii", fmt.ver, fmt.rel, _ENCODING_IBMPC, flags)
    cdr += struct.pack(">iiiii", 0, 0, 0, 3, 0)  # rfuA, rfuB, Increment, Identifier, rfuE
    cdr += b"\x00" * 256  # copyright
    cdr_index = len(b.chunks)
    b.add(fmt.record(1, bytes(cdr)))

    # --- GDR (heads/eof patched later) -----------------------------------------
    names = list(variables)
    gdr = bytearray()
    gdr += fmt.off(0)  # rVDRhead
    gdr_zhead_pos = len(gdr)
    gdr += fmt.off(0)  # zVDRhead (patched)
    gdr_ahead_pos = len(gdr)
    gdr += fmt.off(0)  # ADRhead (patched)
    gdr_eof_pos = len(gdr)
    gdr += fmt.off(0)  # eof (patched)
    gdr += struct.pack(">i", 0)  # NrVars
    gdr_nattr_pos = len(gdr)
    gdr += struct.pack(">i", 0)  # NumAttr (patched)
    gdr += struct.pack(">ii", -1, 0)  # rMaxRec, rNumDims
    gdr += struct.pack(">i", len(names))  # NzVars
    gdr += fmt.off(0)  # UIRhead
    gdr += struct.pack(">iii", 0, 0, 0)  # rfuC, LeapSecondLastUpdated, rfuE
    gdr_index = len(b.chunks)
    gdr_off = b.add(fmt.record(2, bytes(gdr)))
    b.patch_off(cdr_index, cdr_gdr_pos, gdr_off)

    # --- z-variables -------------------------------------------------------------
    zvdr_head = 0
    prev_vdr: tuple[int, int] | None = None  # (chunk index, VDRnext body pos)
    per_var_gzip = compress == "gzip"
    for num, name in enumerate(names):
        arr = np.asarray(variables[name])
        if arr.dtype.name not in _NP_TO_CDF:
            raise ValueError(f"variable {name!r}: unsupported dtype {arr.dtype}")
        n_rec = int(arr.shape[0]) if arr.ndim else 1
        dims = tuple(int(s) for s in arr.shape[1:])
        le = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        if row_major or len(dims) < 2:
            payload = le.tobytes(order="C")
        else:
            # Records are stored sequentially; majority applies only WITHIN
            # a record (CDF spec), so each record's block is emitted
            # column-major while the record axis stays outermost.
            payload = le.transpose(0, *range(arr.ndim - 1, 0, -1)).tobytes(order="C")

        vdr = bytearray()
        vdr_next_pos = len(vdr)
        vdr += fmt.off(0)  # VDRnext (patched by successor)
        vdr += struct.pack(">ii", _NP_TO_CDF[arr.dtype.name], n_rec - 1)  # DataType, MaxRec
        vdr_vxr_pos = len(vdr)
        vdr += fmt.off(0)  # VXRhead (patched)
        vdr_vxrt_pos = len(vdr)
        vdr += fmt.off(0)  # VXRtail (patched)
        vdr += struct.pack(">ii", 0x1 | (0x4 if per_var_gzip else 0), 0)  # Flags, SRecords
        vdr += struct.pack(">iii", 0, 0, -1)  # rfuB, rfuC, rfuF
        vdr += struct.pack(">ii", 1, num)  # NumElems, Num
        vdr_cpr_pos = len(vdr)
        vdr += fmt.off(0)  # CPRorSPRoffset (patched when gzip)
        vdr += struct.pack(">i", n_rec)  # BlockingFactor
        vdr += fmt.name(name)
        vdr += struct.pack(">i", len(dims))
        for d in dims:
            vdr += struct.pack(">i", d)
        vdr += struct.pack(">i", -1) * len(dims)  # DimVarys: all true
        vdr_index = len(b.chunks)
        vdr_off = b.add(fmt.record(8, bytes(vdr)))
        if prev_vdr is None:
            zvdr_head = vdr_off
        else:
            b.patch_off(prev_vdr[0], prev_vdr[1], vdr_off)
        prev_vdr = (vdr_index, vdr_next_pos)

        if per_var_gzip:
            cpr_off = b.add(fmt.record(11, struct.pack(">iiii", 5, 0, 1, 6)))  # GZIP level 6
            b.patch_off(vdr_index, vdr_cpr_pos, cpr_off)
            cdata = gzip.compress(payload, compresslevel=6)
            data_off = b.add(fmt.record(13, struct.pack(">i", 0) + fmt.off(len(cdata)) + cdata))
        else:
            data_off = b.add(fmt.record(7, payload))

        vxr = bytearray()
        vxr += fmt.off(0)  # VXRnext
        vxr += struct.pack(">ii", 1, 1)  # Nentries, NusedEntries
        vxr += struct.pack(">ii", 0, n_rec - 1)  # First, Last
        vxr += fmt.off(data_off)
        vxr_off = b.add(fmt.record(6, bytes(vxr)))
        b.patch_off(vdr_index, vdr_vxr_pos, vxr_off)
        b.patch_off(vdr_index, vdr_vxrt_pos, vxr_off)

    # --- global attributes ----------------------------------------------------------
    gattrs = dict(global_attrs or {})
    adr_head = 0
    prev_adr: tuple[int, int] | None = None
    for attr_num, (aname, avalue) in enumerate(gattrs.items()):
        adr = bytearray()
        adr_next_pos = len(adr)
        adr += fmt.off(0)  # ADRnext (patched by successor)
        adr_aedr_pos = len(adr)
        adr += fmt.off(0)  # AgrEDRhead (patched)
        adr += struct.pack(">ii", 1, attr_num)  # Scope=global, Num
        adr += struct.pack(">iii", 1, 0, 0)  # NgrEntries, MAXgrEntry, rfuA
        adr += fmt.off(0)  # AzEDRhead
        adr += struct.pack(">iii", 0, -1, 0)  # NzEntries, MAXzEntry, rfuE
        adr += fmt.name(aname)
        adr_index = len(b.chunks)
        adr_off = b.add(fmt.record(4, bytes(adr)))
        if prev_adr is None:
            adr_head = adr_off
        else:
            b.patch_off(prev_adr[0], prev_adr[1], adr_off)
        prev_adr = (adr_index, adr_next_pos)

        if isinstance(avalue, str):
            raw = avalue.encode("latin-1")
            a_dtype, a_elems, a_payload = 51, max(1, len(raw)), raw
        else:
            val = np.asarray(avalue)
            a_dtype = _NP_TO_CDF[val.dtype.name]
            a_elems = int(val.size)
            a_payload = val.astype(val.dtype.newbyteorder("<"), copy=False).tobytes()
        aedr = bytearray()
        aedr += fmt.off(0)  # AEDRnext
        aedr += struct.pack(">ii", attr_num, a_dtype)
        aedr += struct.pack(">ii", 0, a_elems)  # entry Num, NumElems
        aedr += struct.pack(">iiiii", 0, 0, 0, 0, 0)  # NumStrings/rfuA..rfuE
        aedr += a_payload
        aedr_off = b.add(fmt.record(5, bytes(aedr)))
        b.patch_off(adr_index, adr_aedr_pos, aedr_off)

    b.patch_off(gdr_index, gdr_zhead_pos, zvdr_head)
    b.patch_off(gdr_index, gdr_ahead_pos, adr_head)
    b.patch_off(gdr_index, gdr_eof_pos, b.pos)
    b.patch_i4(gdr_index, gdr_nattr_pos, len(gattrs))

    blob = b"".join(b.chunks)
    if compress == "file":
        body = blob[8:]
        cdata = gzip.compress(body, compresslevel=6)
        ccr = fmt.off(0) + fmt.off(len(body)) + struct.pack(">i", 0) + cdata
        blob = struct.pack(">II", fmt.magic1, 0xCCCC0001) + fmt.record(10, ccr)
    if checksum:
        import hashlib

        blob += hashlib.md5(blob).digest()
    with open(path, "wb") as f:
        f.write(blob)
    return path
