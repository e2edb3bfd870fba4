"""Reader for single-file NASA CDF V2.6/2.7 and V3.x files.

Implements the subset of the public CDF internal-format specification
needed to load FAST ESA L2 instrument files (and general scientific CDFs):

* uncompressed and whole-file GZIP-compressed (CCR) containers
* z-variables and r-variables, row- or column-major
* uncompressed (VVR) and GZIP-compressed (CVVR) variable records,
  including nested VXR trees and sparse/missing records (pad-filled)
* global and per-variable attributes (ADR/AEDR)
* all numeric data types plus CHAR/UCHAR and EPOCH/EPOCH16/TT2000

Control metadata (record headers, offsets, counts) is always big-endian
per the specification; variable data and attribute values honor the
file's encoding field.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any

import numpy as np

# Record types.
_CDR, _GDR, _RVDR, _ADR, _AGREDR, _VXR, _VVR, _ZVDR, _AZEDR, _CCR, _CPR, _SPR, _CVVR = range(1, 14)

#: data-type code -> (numpy dtype string without byte order, element size)
_DATA_TYPES: dict[int, tuple[str, int]] = {
    1: ("i1", 1),  # CDF_INT1
    2: ("i2", 2),  # CDF_INT2
    4: ("i4", 4),  # CDF_INT4
    8: ("i8", 8),  # CDF_INT8
    11: ("u1", 1),  # CDF_UINT1
    12: ("u2", 2),  # CDF_UINT2
    14: ("u4", 4),  # CDF_UINT4
    21: ("f4", 4),  # CDF_REAL4
    22: ("f8", 8),  # CDF_REAL8
    31: ("f8", 8),  # CDF_EPOCH
    32: ("f8", 8),  # CDF_EPOCH16 (2 per element, handled specially)
    33: ("i8", 8),  # CDF_TIME_TT2000
    41: ("i1", 1),  # CDF_BYTE
    44: ("f4", 4),  # CDF_FLOAT
    45: ("f8", 8),  # CDF_DOUBLE
    51: ("S", 1),  # CDF_CHAR
    52: ("S", 1),  # CDF_UCHAR
}

#: encodings whose variable data is big-endian.
_BIG_ENDIAN_ENCODINGS = {1, 2, 5, 7, 9, 11, 12, 14, 15, 17}


class CDFError(Exception):
    """Raised for malformed, unsupported, or non-CDF input files."""


@dataclass
class _Variable:
    name: str
    num: int
    data_type: int
    num_elems: int
    dim_sizes: tuple[int, ...]
    dim_varys: tuple[bool, ...]
    max_rec: int
    rec_vary: bool
    vxr_head: int
    compressed: bool
    pad: np.ndarray | None
    is_z: bool
    sparse: int = 0
    attributes: dict[str, Any] = field(default_factory=dict)

    @property
    def shape(self) -> tuple[int, ...]:
        phys = tuple(s for s, v in zip(self.dim_sizes, self.dim_varys) if v)
        return (self.max_rec + 1, *phys)


class CDF:
    """A parsed, in-memory single-file CDF.

    Usable as a context manager for call-site parity with ``cdflib.CDF``
    (reference cdf_utils.py:172,246).  The whole file is decoded lazily:
    metadata at construction, each variable's data on first ``varget``.
    """

    def __init__(self, path: str, validate: bool = False):
        self.path = str(path)
        with open(self.path, "rb") as f:
            raw = f.read()
        if len(raw) < 16:
            raise CDFError(f"{path} is not a CDF file (too short)")
        magic1, magic2 = struct.unpack(">II", raw[:8])
        if magic1 == 0xCDF30001:
            self._v3 = True
        elif magic1 in (0xCDF26002, 0x0000FFFF):
            self._v3 = False
        else:
            raise CDFError(f"{path} is not a CDF file or a non-supported CDF! (magic {magic1:#x})")
        if magic2 == 0xCCCC0001:
            # Whole-file compression: the body is one CCR whose data section
            # holds the gzip-compressed remainder of an uncompressed CDF.
            self._buf = raw[:8] + self._decompress_ccr(raw)
        elif magic2 == 0x0000FFFF:
            self._buf = raw
        else:
            raise CDFError(f"{path}: unsupported second magic {magic2:#x}")
        self._off = 8
        self._vars: dict[str, _Variable] = {}
        self._cache: dict[str, np.ndarray] = {}
        self.globalattsget_cache: dict[str, Any] | None = None
        try:
            self._parse()
        except CDFError:
            raise
        except (struct.error, IndexError, ValueError) as exc:
            # Truncated or structurally invalid container: surface a CDFError
            # whose message the error-reason classifier maps to 'invalid-cdf'.
            raise CDFError(f"{path} is not a CDF file or a non-supported CDF! ({exc})") from exc
        if validate and self._has_checksum:
            # The 16-byte MD5 signature covers the physical dotCDF file (the
            # compressed bytes for CCR files), everything but itself.
            import hashlib

            if len(raw) < 24 or hashlib.md5(raw[:-16]).digest() != raw[-16:]:
                raise CDFError(f"{path}: MD5 checksum mismatch (file corrupted)")

    # -- low-level helpers --------------------------------------------------

    def _decompress_ccr(self, raw: bytes) -> bytes:
        # CCR: RecordSize, RecordType(=10), CPRoffset, uSize, rfuA, data...
        if self._v3:
            rec_size, rec_type = struct.unpack_from(">qi", raw, 8)
            header = 8 + 8 + 4 + 8 + 8 + 4  # size,type,CPRoffset,uSize,rfuA
        else:
            rec_size, rec_type = struct.unpack_from(">ii", raw, 8)
            header = 8 + 4 + 4 + 4 + 4 + 4
        if rec_type != _CCR:
            raise CDFError("compressed CDF without CCR record")
        cdata = raw[header : 8 + rec_size]
        try:
            from configurable_spectrograms_torch.data.cdf._inflate import gzip_decompress

            return gzip_decompress(cdata)
        except OSError as exc:
            raise CDFError(f"failed to decompress CCR: {exc}") from exc

    def _i(self, off: int) -> tuple[int, int]:
        """Read an offset-sized integer (8 bytes V3, 4 bytes V2) at *off*."""
        if self._v3:
            return struct.unpack_from(">q", self._buf, off)[0], off + 8
        return struct.unpack_from(">i", self._buf, off)[0], off + 4

    def _i4(self, off: int) -> tuple[int, int]:
        return struct.unpack_from(">i", self._buf, off)[0], off + 4

    def _name(self, off: int) -> tuple[str, int]:
        n = 256 if self._v3 else 64
        raw = bytes(self._buf[off : off + n])
        return raw.split(b"\x00", 1)[0].decode("latin-1").strip(), off + n

    def _rec_header(self, off: int) -> tuple[int, int, int]:
        """Return (record_size, record_type, body_offset) for record at *off*."""
        if self._v3:
            size, rtype = struct.unpack_from(">qi", self._buf, off)
            return size, rtype, off + 12
        size, rtype = struct.unpack_from(">ii", self._buf, off)
        return size, rtype, off + 8

    # -- metadata parse ------------------------------------------------------

    def _parse(self) -> None:
        buf = self._buf
        # CDR directly follows the magic numbers.
        _, rtype, body = self._rec_header(8)
        if rtype != _CDR:
            raise CDFError(f"{self.path}: first record is not a CDR")
        gdr_off, p = self._i(body)
        self._version, p = self._i4(p)
        self._release, p = self._i4(p)
        self._encoding, p = self._i4(p)
        flags, p = self._i4(p)
        self._row_major = bool(flags & 0x1)
        self._single_file = bool(flags & 0x2)
        self._has_checksum = bool(flags & 0x4) and bool(flags & 0x8)  # MD5 signature present
        if not self._single_file:
            raise CDFError(f"{self.path}: multi-file CDFs are not supported")
        self._data_be = self._encoding in _BIG_ENDIAN_ENCODINGS

        # GDR
        _, rtype, body = self._rec_header(gdr_off)
        if rtype != _GDR:
            raise CDFError(f"{self.path}: bad GDR offset")
        rvdr_head, p = self._i(body)
        zvdr_head, p = self._i(p)
        adr_head, p = self._i(p)
        _eof, p = self._i(p)
        n_rvars, p = self._i4(p)
        self._num_attrs, p = self._i4(p)
        _r_max_rec, p = self._i4(p)
        r_num_dims, p = self._i4(p)
        n_zvars, p = self._i4(p)
        _uir_head, p = self._i(p)
        _rfu_c, p = self._i4(p)
        _leap, p = self._i4(p)
        _rfu_e, p = self._i4(p)
        r_dim_sizes = []
        for _ in range(r_num_dims):
            d, p = self._i4(p)
            r_dim_sizes.append(d)
        self._r_dim_sizes = tuple(r_dim_sizes)

        off = zvdr_head
        for _ in range(n_zvars):
            off = self._parse_vdr(off, is_z=True)
        off = rvdr_head
        for _ in range(n_rvars):
            off = self._parse_vdr(off, is_z=False)
        self._parse_attributes(adr_head)

    def _parse_vdr(self, off: int, is_z: bool) -> int:
        _, rtype, body = self._rec_header(off)
        if rtype != (_ZVDR if is_z else _RVDR):
            raise CDFError(f"{self.path}: bad VDR chain at {off}")
        vdr_next, p = self._i(body)
        data_type, p = self._i4(p)
        max_rec, p = self._i4(p)
        vxr_head, p = self._i(p)
        _vxr_tail, p = self._i(p)
        flags, p = self._i4(p)
        srecords, p = self._i4(p)
        p += 12  # rfuB, rfuC, rfuF
        num_elems, p = self._i4(p)
        num, p = self._i4(p)
        _cpr_off, p = self._i(p)
        _blocking, p = self._i4(p)
        name, p = self._name(p)
        if is_z:
            z_num_dims, p = self._i4(p)
            dims = []
            for _ in range(z_num_dims):
                d, p = self._i4(p)
                dims.append(d)
            dim_sizes = tuple(dims)
        else:
            dim_sizes = self._r_dim_sizes
        varys = []
        for _ in range(len(dim_sizes)):
            v, p = self._i4(p)
            varys.append(bool(v))
        pad = None
        if flags & 0x2:  # pad value specified
            pad = self._decode_values(p, data_type, num_elems, 1)
        var = _Variable(
            name=name,
            num=num,
            data_type=data_type,
            num_elems=num_elems,
            dim_sizes=dim_sizes,
            dim_varys=tuple(varys),
            max_rec=max_rec,
            rec_vary=bool(flags & 0x1),
            vxr_head=vxr_head,
            compressed=bool(flags & 0x4),
            pad=pad,
            is_z=is_z,
            sparse=srecords,
        )
        self._vars[name] = var
        return vdr_next

    def _parse_attributes(self, adr_head: int) -> None:
        self._gattrs: dict[str, Any] = {}
        self._vattrs: dict[int, dict[str, Any]] = {}
        off = adr_head
        for _ in range(self._num_attrs):
            if off == 0:
                break
            _, rtype, body = self._rec_header(off)
            if rtype != _ADR:
                raise CDFError(f"{self.path}: bad ADR chain at {off}")
            adr_next, p = self._i(body)
            agredr_head, p = self._i(p)
            scope, p = self._i4(p)
            _num, p = self._i4(p)
            n_gr, p = self._i4(p)
            _max_gr, p = self._i4(p)
            _rfu_a, p = self._i4(p)
            azedr_head, p = self._i(p)
            n_z, p = self._i4(p)
            _max_z, p = self._i4(p)
            _rfu_e, p = self._i4(p)
            name, p = self._name(p)
            if scope in (1, 3):  # global (3 = global-assumed, legacy pre-2.5 files)
                entries = self._read_aedrs(agredr_head, n_gr)
                vals = [v for _, v in sorted(entries.items())]
                self._gattrs[name] = vals[0] if len(vals) == 1 else vals
            else:  # variable scope (2/4): gr entries apply to r-vars, z to z-vars
                for var_num, value in self._read_aedrs(azedr_head, n_z).items():
                    self._vattrs.setdefault(var_num, {})[name] = value
                for var_num, value in self._read_aedrs(agredr_head, n_gr).items():
                    self._vattrs.setdefault(-var_num - 1, {})[name] = value
            off = adr_next
        for var in self._vars.values():
            key = var.num if var.is_z else -var.num - 1
            var.attributes = self._vattrs.get(key, {})

    def _read_aedrs(self, head: int, count: int) -> dict[int, Any]:
        out: dict[int, Any] = {}
        off = head
        for _ in range(count):
            if off == 0:
                break
            _, rtype, body = self._rec_header(off)
            if rtype not in (_AGREDR, _AZEDR):
                raise CDFError(f"{self.path}: bad AEDR chain at {off}")
            aedr_next, p = self._i(body)
            _attr_num, p = self._i4(p)
            data_type, p = self._i4(p)
            num, p = self._i4(p)
            num_elems, p = self._i4(p)
            p += 20  # NumStrings/rfuA, rfuB, rfuC, rfuD, rfuE (5 x int32)
            value = self._decode_values(p, data_type, num_elems, 1)
            if data_type in (51, 52):
                out[num] = value  # already a str
            else:
                arr = np.asarray(value).reshape(-1)
                out[num] = arr.item() if arr.size == 1 else arr
            off = aedr_next
        return out

    def _decode_values(self, off: int, data_type: int, num_elems: int, count: int):
        """Decode *count* values (each of *num_elems* elements) at *off*."""
        if data_type not in _DATA_TYPES:
            raise CDFError(f"{self.path}: unsupported CDF data type {data_type}")
        base, size = _DATA_TYPES[data_type]
        if base == "S":
            raw = bytes(self._buf[off : off + num_elems * count])
            if count == 1:
                return raw.split(b"\x00", 1)[0].decode("latin-1").rstrip()
            return np.frombuffer(raw, dtype=f"S{num_elems}")
        bo = ">" if self._data_be else "<"
        n = num_elems * count * (2 if data_type == 32 else 1)
        arr = np.frombuffer(self._buf, dtype=f"{bo}{base}", count=n, offset=off)
        return arr

    # -- public API -----------------------------------------------------------

    def __enter__(self) -> "CDF":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def close(self) -> None:
        self._cache.clear()

    def cdf_info(self) -> dict[str, Any]:
        """Summary info dict (version, encoding, majority, variable names)."""
        return {
            "Version": f"{self._version}.{self._release}",
            "Majority": "Row_major" if self._row_major else "Column_major",
            "Encoding": self._encoding,
            "zVariables": [v.name for v in self._vars.values() if v.is_z],
            "rVariables": [v.name for v in self._vars.values() if not v.is_z],
            "Attributes": sorted(self._gattrs),
            "Checksum": "MD5" if self._has_checksum else None,
        }

    def variables(self) -> list[str]:
        return list(self._vars)

    def varinq(self, name: str) -> dict[str, Any]:
        var = self._var(name)
        return {
            "Variable": var.name,
            "Num": var.num,
            "Data_Type": var.data_type,
            "Num_Elements": var.num_elems,
            "Dim_Sizes": list(var.dim_sizes),
            "Dim_Vary": [bool(v) for v in var.dim_varys],
            "Rec_Vary": var.rec_vary,
            "Last_Rec": var.max_rec,
            "Compress": var.compressed,
        }

    def globalattsget(self) -> dict[str, Any]:
        return dict(self._gattrs)

    def varattsget(self, name: str) -> dict[str, Any]:
        return dict(self._var(name).attributes)

    def _var(self, name: str) -> _Variable:
        if name not in self._vars:
            raise CDFError(f"{self.path}: no variable named {name!r}")
        return self._vars[name]

    def varget(self, name: str) -> np.ndarray | None:
        """Return the full data array for variable *name*.

        Shape is ``(num_records, *varying_dims)`` for record-varying
        variables, or just ``(*varying_dims,)``  when a single record
        exists for a non-record-varying variable (matching cdflib).
        """
        if name in self._cache:
            return self._cache[name]
        var = self._var(name)
        if var.max_rec < 0:
            return None
        base, size = _DATA_TYPES[var.data_type]
        phys_dims = tuple(s for s, v in zip(var.dim_sizes, var.dim_varys) if v)
        if base == "S":
            rec_dtype = np.dtype(f"S{var.num_elems}")
            values_per_rec = int(np.prod(phys_dims, dtype=np.int64)) if phys_dims else 1
            rec_bytes = values_per_rec * var.num_elems
        else:
            bo = ">" if self._data_be else "<"
            rec_dtype = np.dtype(f"{bo}{base}")
            mult = 2 if var.data_type == 32 else 1
            values_per_rec = (int(np.prod(phys_dims, dtype=np.int64)) if phys_dims else 1) * var.num_elems * mult
            rec_bytes = values_per_rec * size

        n_rec = var.max_rec + 1
        out = np.empty(n_rec * values_per_rec, dtype=rec_dtype)
        if var.pad is not None and base != "S":
            pad_val = np.asarray(var.pad).reshape(-1)[0]
        elif base == "S":
            pad_val = b" " * var.num_elems
        else:
            pad_val = 0
        # Records the VXR tree never covers get the pad value; filling only
        # the gaps (usually none) instead of pre-filling the whole buffer
        # saves a full-size memset pass on every variable load.
        spans: list[tuple[int, int]] = []
        self._fill_from_vxr(var.vxr_head, out, values_per_rec, rec_bytes, rec_dtype, n_rec, spans)
        spans.sort()
        cursor = 0
        for first, last in spans:
            if first > cursor:
                out[cursor * values_per_rec : first * values_per_rec] = pad_val
            cursor = max(cursor, last + 1)
        if cursor < n_rec:
            out[cursor * values_per_rec :] = pad_val

        if base == "S":
            arr: np.ndarray = out
        else:
            arr = out.astype(rec_dtype.newbyteorder("="), copy=False)
        # EPOCH16 values are two consecutive doubles per element -- the
        # component pair stays innermost regardless of majority.
        comp = (2,) if var.data_type == 32 else ()

        def _shape_records(flat: np.ndarray, lead: tuple[int, ...]) -> np.ndarray:
            """Reshape *flat* to (*lead, *phys_dims, *comp) honoring majority.

            Records are stored sequentially in the file; majority applies
            only WITHIN a record (CDF spec) -- a whole-buffer Fortran
            reshape would interleave the record axis across records.
            """
            if self._row_major or len(phys_dims) < 2:
                return flat.reshape((*lead, *phys_dims, *comp))
            nd = len(phys_dims)
            shaped = flat.reshape((*lead, *phys_dims[::-1], *comp))
            nlead = len(lead)
            axes = (
                *range(nlead),
                *range(nlead + nd - 1, nlead - 1, -1),
                *((nlead + nd,) if comp else ()),
            )
            return shaped.transpose(axes)

        if var.rec_vary:
            arr = _shape_records(arr, (n_rec,))
        elif phys_dims or comp:
            arr = _shape_records(arr, ())
        else:
            arr = arr.reshape(())
        self._cache[name] = arr
        return arr

    def _fill_from_vxr(
        self,
        vxr_off: int,
        out: np.ndarray,
        values_per_rec: int,
        rec_bytes: int,
        rec_dtype: np.dtype,
        n_rec: int,
        spans: list[tuple[int, int]],
    ) -> None:
        """Walk a VXR chain/tree, decoding VVR/CVVR leaves into *out*.

        Every decoded record range is appended to *spans* so the caller can
        pad-fill only the gaps.
        """
        while vxr_off:
            _, rtype, body = self._rec_header(vxr_off)
            if rtype != _VXR:
                raise CDFError(f"{self.path}: bad VXR at {vxr_off}")
            vxr_next, p = self._i(body)
            n_entries, p = self._i4(p)
            n_used, p = self._i4(p)
            firsts = []
            lasts = []
            for _ in range(n_entries):
                v, p = self._i4(p)
                firsts.append(v)
            for _ in range(n_entries):
                v, p = self._i4(p)
                lasts.append(v)
            offsets = []
            for _ in range(n_entries):
                v, p = self._i(p)
                offsets.append(v)
            for k in range(n_used):
                first, last, off = firsts[k], lasts[k], offsets[k]
                if off == 0:
                    continue
                size, rtype, body = self._rec_header(off)
                if rtype == _VXR:  # nested index tree
                    self._fill_from_vxr(off, out, values_per_rec, rec_bytes, rec_dtype, n_rec, spans)
                    continue
                first = max(0, first)
                last = min(last, n_rec - 1)
                count = last - first + 1
                if count <= 0:
                    continue
                spans.append((first, last))
                if rtype == _VVR:
                    raw = self._buf[body : body + count * rec_bytes]
                elif rtype == _CVVR:
                    from configurable_spectrograms_torch.data.cdf._inflate import (
                        gzip_decompress,
                        gzip_decompress_into,
                    )

                    _rfu, p2 = self._i4(body)
                    csize, p2 = self._i(p2)
                    comp = bytes(self._buf[p2 : p2 + csize])
                    # Fast path: inflate straight into the destination slice
                    # (no scratch buffer, no frombuffer+assign copy).  Only
                    # valid when the stream's ISIZE matches the slice
                    # exactly, i.e. `last` was not clamped.
                    dest = out[first * values_per_rec : (last + 1) * values_per_rec]
                    if gzip_decompress_into(comp, dest):
                        continue
                    raw = gzip_decompress(comp)[: count * rec_bytes]
                else:
                    raise CDFError(f"{self.path}: unexpected record type {rtype} in VXR leaf")
                vals = np.frombuffer(raw, dtype=rec_dtype, count=count * values_per_rec)
                out[first * values_per_rec : (last + 1) * values_per_rec] = vals
            vxr_off = vxr_next
