"""Device-resident padded cubes, pinned staging uploads and upload telemetry (port of ``render/device_cache.py``).

A batch renders each cube many times: the raw and given-extrema figure of a
pair, the pitch grid and the instrument grid, every scale combo of an
orbit-major batch.  Uploading the cube for each bucket shipped the same
268 MB (an 8192x64x128 float32 cube) over PCIe again and again, so the
NaN-padded ``(Tp, Ap, Ep)`` cube stays on the device, keyed by
``(id(cube), Tp, Ap, Ep)`` in the cache of its device, and a repeat
render ships nothing.
Owner-death eviction (:class:`..utils.resident_cache.ResidentCache`) keeps
a recycled ``id`` from aliasing a stale entry.  Each device has its own
cache, bounded (FIFO) by :func:`device_cube_budget`: the JAX package's
``CST_DEVICE_CUBE_CACHE_BYTES`` where it is set, read at every insert,
else a quarter of that device's memory: 20 GB on an 80 GB card, room for
the padded one-pitch audio cube (1.72 GB) and many orbits' instrument
cubes (the JAX package's default, 1.5 GB, would hold no audio cube).
``CST_DEVICE_CUBE_CACHE=0`` turns the cache off (every bucket uploads its
cubes, through the same staging).

A miss on a CUDA device copies the cube into a pinned staging buffer on
the host and from there, with ``non_blocking=True``, on a side copy stream
into its padded device tensor (the padding is filled on the device, so
only the cube's own bytes cross PCIe); the compute stream waits on the
copy's event.  The padded tensor is the compute stream's allocation,
with ``record_stream`` for the copy stream that wrote it.  A staging
buffer is reused only once its copy event has completed.  On the CPU
nothing asks for pinned memory: the choice is made on ``device.type``.

The bucket's ``(U, Tp, Ap, Ep)`` stack is assembled on the device from
the resident cubes (a view for one cube, ``torch.stack`` for several).
The JAX package caches the assembled stack as well, keyed by the tuple of
cube ids; the port does not: a second resident copy of an orbit's cubes
would halve what the budget holds, and the device-side copy it saves is
bound by HBM (about 0.16 ms for 268 MB read and written at 3.35 TB/s)
where an upload is bound by PCIe.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np
import torch

from configurable_spectrograms_torch.utils.resident_cache import ResidentCache

#: Cumulative upload telemetry: ``upload_bytes`` of cubes shipped
#: host-to-device (the cube's own bytes; 0 on a cache hit), bucket ``dispatches`` enqueued,
#: ``lanes`` enqueued, and the cube cache's ``cube_hits`` / ``cube_misses``.
#: Worker threads and the coalescer's dispatcher add to it, so every count
#: is taken under :data:`_TELEMETRY_LOCK` (a ``+=`` is not atomic).
UPLOAD_TELEMETRY = {"upload_bytes": 0, "dispatches": 0, "lanes": 0, "cube_hits": 0, "cube_misses": 0}
_TELEMETRY_LOCK = threading.Lock()


def count(**increments: int) -> None:
    with _TELEMETRY_LOCK:
        for k, v in increments.items():
            UPLOAD_TELEMETRY[k] += v


def upload_telemetry() -> dict[str, int]:
    """Snapshot of :data:`UPLOAD_TELEMETRY`."""
    with _TELEMETRY_LOCK:
        return dict(UPLOAD_TELEMETRY)


def reset_upload_telemetry() -> None:
    with _TELEMETRY_LOCK:
        for k in UPLOAD_TELEMETRY:
            UPLOAD_TELEMETRY[k] = 0


def cache_enabled() -> bool:
    return os.environ.get("CST_DEVICE_CUBE_CACHE", "1") != "0"


@dataclass
class Resident:
    """A padded cube on its device, and the event its upload recorded (None on the CPU)."""

    tensor: torch.Tensor
    ready: object = None

    @property
    def nbytes(self) -> int:  # what ResidentCache budgets
        return self.tensor.nbytes


def device_cube_budget(device: torch.device) -> int:
    """Bytes the resident cubes of *device* may hold.

    ``CST_DEVICE_CUBE_CACHE_BYTES`` where it is set and parses as an
    integer (the JAX package's rule: a value that does not parse gives the
    default); the default is a quarter of the device's memory (host RAM
    for the CPU).
    """
    value = os.environ.get("CST_DEVICE_CUBE_CACHE_BYTES")
    if value is not None:
        try:
            return int(value)
        except ValueError:
            pass
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total // 4


#: One resident-cube cache per device (``str(device)``), made at its first use.
_CUBE_CACHES: dict[str, ResidentCache] = {}
_CACHES_LOCK = threading.Lock()


def cube_cache(device: torch.device) -> ResidentCache:
    """The resident-cube cache of *device*, bounded by :func:`device_cube_budget` as it reads at each insert."""
    with _CACHES_LOCK:
        cache = _CUBE_CACHES.get(str(device))
        if cache is None:
            cache = _CUBE_CACHES[str(device)] = ResidentCache(max_bytes=lambda: device_cube_budget(device))
        return cache


def clear_cube_caches() -> None:
    with _CACHES_LOCK:
        for cache in _CUBE_CACHES.values():
            cache.clear()


class StagingPool:
    """Host staging buffers for uploads, reused only after their copy event has completed.

    ``take(nbytes)`` prefers a free buffer whose event has completed; with
    *keep* buffers allocated and none ready it waits on a free one's event;
    otherwise it allocates.  ``give(buf, event)`` returns a buffer with the
    event of the copy that reads it, and frees the oldest beyond *keep*.
    *alloc* makes a buffer of at least ``nbytes`` uint8 (pinned by default).
    ``peak`` is the most buffers that were allocated at once: at most
    *keep* plus the uploads in flight together.
    """

    def __init__(self, keep: int = 2, alloc=None):
        self.keep = keep
        self._alloc = alloc or (lambda n: torch.empty((n,), dtype=torch.uint8, pin_memory=True))
        self._free: list[tuple[torch.Tensor, object]] = []
        self._allocated = 0
        self.peak = 0
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            fits = [i for i, (buf, _) in enumerate(self._free) if buf.numel() >= nbytes]
            ready = [i for i in fits if self._free[i][1] is None or self._free[i][1].query()]
            pick = ready[0] if ready else (fits[0] if fits and self._allocated >= self.keep else None)
            if pick is None:
                self._allocated += 1
                self.peak = max(self.peak, self._allocated)
            else:
                buf, event = self._free.pop(pick)
        if pick is None:
            return self._alloc(nbytes)
        if not ready:
            event.synchronize()  # its copy may still be reading it
        return buf

    def reset_peak(self) -> None:
        """Start ``peak`` again from the buffers allocated now."""
        with self._lock:
            self.peak = self._allocated

    def give(self, buf: torch.Tensor, event) -> None:
        with self._lock:
            self._free.append((buf, event))
            while len(self._free) > self.keep:
                self._free.pop(0)
                self._allocated -= 1


_STAGING = StagingPool()
_COPY_STREAMS: dict[int, torch.cuda.Stream] = {}
_STREAM_LOCK = threading.Lock()


def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _STREAM_LOCK:
        if index not in _COPY_STREAMS:
            _COPY_STREAMS[index] = torch.cuda.Stream(device=index)
        return _COPY_STREAMS[index]


def _pad_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy the (T, A, E) *src* into the corner of *dst*, NaN elsewhere (on *dst*'s device and stream)."""
    if tuple(src.shape) == tuple(dst.shape):
        dst.copy_(src, non_blocking=True)
    else:
        T, A, E = src.shape
        dst.fill_(float("nan"))
        dst[:T, :A, :E].copy_(src, non_blocking=True)


def upload_cube(cube: np.ndarray, Tp: int, Ap: int, Ep: int, device: torch.device,
                out: torch.Tensor | None = None) -> Resident:
    """A NaN-padded (Tp, Ap, Ep) float32 copy of *cube* on *device* (into *out* where given).

    Only the cube's own bytes cross to the device (and are counted): the
    padding is filled there.  *out*, where given, is a tensor of the
    compute stream, which the copy stream waits for before writing it.
    """
    src = np.ascontiguousarray(cube, np.float32)
    count(upload_bytes=src.nbytes)
    if out is None:
        out = torch.empty((Tp, Ap, Ep), dtype=torch.float32, device=device)
        fresh = True
    else:
        fresh = False
    if device.type != "cuda":
        _pad_into(out, torch.from_numpy(src))
        return Resident(out)
    buf = _STAGING.take(src.nbytes)
    host = buf[: src.nbytes].view(torch.float32).view(src.shape)
    host.copy_(torch.from_numpy(src))
    stream = _copy_stream(device)
    compute = torch.cuda.current_stream(device)
    stream.wait_stream(compute)  # *out* is the compute stream's memory
    with torch.cuda.stream(stream):
        _pad_into(out, host)
        ready = torch.cuda.Event()
        ready.record(stream)
    if fresh:
        out.record_stream(stream)
    _STAGING.give(buf, ready)
    compute.wait_event(ready)
    return Resident(out, ready)


def _padded_device_cube(cube: np.ndarray, Tp: int, Ap: int, Ep: int, device: torch.device) -> torch.Tensor:
    """The resident padded copy of *cube*, uploading it on a miss; the compute stream waits for it."""
    cache = cube_cache(device)
    key = (id(cube), Tp, Ap, Ep)
    hit = cache.get(key)
    if hit is None:
        count(cube_misses=1)
        hit = cache.insert(key, upload_cube(cube, Tp, Ap, Ep, device), (cube,))
    else:
        count(cube_hits=1)
    if hit.ready is not None:
        torch.cuda.current_stream(device).wait_event(hit.ready)
    return hit.tensor


def stack_cubes(cubes: list[np.ndarray], Tp: int, Ap: int, Ep: int, device: torch.device,
                cached: bool | None = None) -> torch.Tensor:
    """The (U, Tp, Ap, Ep) input of a bucket on *device*.

    *cached* (default: :func:`cache_enabled`) takes resident cubes, a view
    for one cube and a device-side ``torch.stack`` for several; otherwise
    every cube is uploaded into one fresh tensor and nothing stays resident.
    """
    if cache_enabled() if cached is None else cached:
        tensors = [_padded_device_cube(c, Tp, Ap, Ep, device) for c in cubes]
        return tensors[0].unsqueeze(0) if len(tensors) == 1 else torch.stack(tensors)
    out = torch.empty((len(cubes), Tp, Ap, Ep), dtype=torch.float32, device=device)
    for u, c in enumerate(cubes):
        upload_cube(c, Tp, Ap, Ep, device, out=out[u])
    return out
