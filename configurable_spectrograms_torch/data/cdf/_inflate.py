"""gzip decompression via libdeflate (ctypes), with stdlib fallback.

CDF archives store their bulk data gzip-compressed (per-variable CVVR
records or a whole-file CCR), and profiling shows ``gzip.decompress``
dominating dataset load time (~160 ms of a 194 ms load at real FAST
dimensions).  libdeflate inflates the same streams ~2-3x faster and
checks the trailing CRC32 with a hardware path.  Any load/alloc/format
failure falls back to :func:`gzip.decompress`, so the reader never
depends on libdeflate being installed.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import gzip
import struct
import threading


def _load() -> ctypes.CDLL | None:
    name = ctypes.util.find_library("deflate")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
        lib.libdeflate_alloc_decompressor.restype = ctypes.c_void_p
        lib.libdeflate_gzip_decompress.restype = ctypes.c_int
        lib.libdeflate_gzip_decompress.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_void_p,  # accepts both string buffers and raw addresses
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        return lib
    except (OSError, AttributeError):
        return None


_LIB = _load()
#: One decompressor handle per thread (they are not thread-safe to share).
_local = threading.local()

#: Largest output buffer the fast path will allocate eagerly.  Real FAST
#: CDF records are tens of MB; anything bigger is a corrupt size field.
_MAX_EAGER_ALLOC = 1 << 30


def _handle():
    decomp = getattr(_local, "handle", None)
    if decomp is None:
        decomp = _LIB.libdeflate_alloc_decompressor()
        if decomp:
            _local.handle = decomp
    return decomp


def gzip_decompress_into(data: bytes, dest) -> bool:
    """Decompress one gzip stream straight into *dest* (a writable,
    C-contiguous numpy array whose ``nbytes`` equals the stream's ISIZE).

    Skips the intermediate string buffer entirely -- no memset of the
    output buffer, no trailing copy, no ``frombuffer``+assign pass; the
    CDF reader points this at the variable's destination slice.  Returns
    False whenever the fast path cannot run; on a mid-stream libdeflate
    failure *dest* is zeroed before returning, so a False return never
    leaves partial decompressed bytes behind (callers may fall back to
    :func:`gzip_decompress`, but correctness no longer depends on it).
    """
    if _LIB is None or len(data) < 18:
        return False
    size = struct.unpack_from("<I", data, len(data) - 4)[0]
    if size != dest.nbytes or not dest.flags["C_CONTIGUOUS"]:
        return False
    decomp = _handle()
    if not decomp:
        return False
    actual = ctypes.c_size_t(0)
    rc = _LIB.libdeflate_gzip_decompress(
        decomp, data, len(data), ctypes.c_void_p(dest.ctypes.data), size, ctypes.byref(actual)
    )
    if rc == 0 and actual.value == size:
        return True
    dest.view("u1").reshape(-1)[...] = 0  # discard any partial prefix
    return False


def gzip_decompress(data: bytes, expected_size: int | None = None) -> bytes:
    """Decompress one gzip stream.

    *expected_size* (when the container records it -- CDF always does)
    sizes the output buffer exactly; without it the gzip trailer's ISIZE
    field supplies the size (exact for streams < 4 GiB, which bounds every
    CDF record this reader accepts).  Falls back to ``gzip.decompress``
    on any libdeflate failure.
    """
    if _LIB is None or len(data) < 18:
        return gzip.decompress(data)
    size = expected_size
    if size is None:
        size = struct.unpack_from("<I", data, len(data) - 4)[0]
    if size > _MAX_EAGER_ALLOC:
        # The trailer (or a caller-forwarded header field) is untrusted: a
        # bit-flipped CDF can claim ~4 GiB and the eager zero-filled buffer
        # below would try to honor it.  zlib streams incrementally and fails
        # fast on corrupt data, so route absurd sizes there.
        return gzip.decompress(data)
    decomp = _handle()
    if not decomp:
        return gzip.decompress(data)
    try:
        out = ctypes.create_string_buffer(size)
    except MemoryError:
        return gzip.decompress(data)
    actual = ctypes.c_size_t(0)
    rc = _LIB.libdeflate_gzip_decompress(
        decomp, data, len(data), out, size, ctypes.byref(actual)
    )
    if rc != 0:  # bad data / short buffer / insufficient space
        return gzip.decompress(data)
    return out.raw[: actual.value]
