"""Id-keyed resident result cache shared by the render-path caches.

Two hot-path caches keep derived results resident across renders, keyed by
the ``id()`` of long-lived host arrays: the host backend's per-mask
collapse matrices (render/host_quantize.py) and the device backend's
padded on-device cubes (render/figure.py).  Both need the same machinery
-- one lock, eviction when an owning array is garbage-collected so a
recycled ``id`` can never alias a stale entry, and a FIFO bound -- so it
lives here once, parameterized by the bound (entry count or bytes).

Owner-death eviction is deliberately two-phase: the ``weakref.finalize``
callback only appends the dead owner's id to a plain list (``list.append``
is atomic and needs no lock), and every ``get``/``insert`` drains that
list under the lock first.  Running the eviction inside the finalizer
itself would deadlock: CPython may run finalizers during any allocation,
including allocations made *while holding this cache's lock*.  The
no-stale-aliasing guarantee survives because finalizers run before the
object's memory -- and therefore its ``id`` -- can be reused: the dead id
is always enqueued before any new owner can occupy it, and the drain runs
before any lookup could hit the stale key.
"""

from __future__ import annotations

import threading
import weakref
from collections.abc import Callable
from typing import Any


class ResidentCache:
    """FIFO-bounded cache whose keys embed ``id(owner)`` of host arrays.

    Exactly one of *max_entries* / *max_bytes* bounds the cache;
    *max_bytes* may be a zero-arg callable so env-var budgets are read at
    insert time.  Values are shared -- callers must not mutate them.
    """

    def __init__(
        self,
        max_entries: int | None = None,
        max_bytes: int | Callable[[], int] | None = None,
    ):
        if (max_entries is None) == (max_bytes is None):
            raise ValueError("exactly one of max_entries/max_bytes required")
        self._cache: dict[Any, Any] = {}
        self._owner_keys: dict[int, list] = {}
        self._dead_owners: list[int] = []
        self.lock = threading.Lock()
        self._total = 0
        self._max_entries = max_entries
        self._max_bytes = max_bytes

    # -- bounds ------------------------------------------------------------

    def _byte_budget(self) -> int:
        b = self._max_bytes
        return b() if callable(b) else b  # type: ignore[return-value]

    @staticmethod
    def _nbytes(value: Any) -> int:
        return int(getattr(value, "nbytes", 0))

    # -- internal (call with self.lock held) -------------------------------

    def _drain_dead(self) -> None:
        while self._dead_owners:
            owner_id = self._dead_owners.pop()
            for key in self._owner_keys.pop(owner_id, []):
                old = self._cache.pop(key, None)
                if old is not None:
                    self._total -= self._nbytes(old)

    def _evict_one(self) -> None:
        old_key, old = next(iter(self._cache.items()))
        del self._cache[old_key]
        self._total -= self._nbytes(old)
        for keys in self._owner_keys.values():
            try:
                keys.remove(old_key)
            except ValueError:
                pass

    # -- public ------------------------------------------------------------

    def get(self, key) -> Any | None:
        with self.lock:
            self._drain_dead()
            return self._cache.get(key)

    def insert(self, key, value, owners: tuple) -> Any:
        """Cache *value* under *key* unless present; returns the winner.

        *owners* are the host arrays whose lifetime bounds the entry's.  In
        bytes mode a value that alone exceeds the budget is returned
        uncached (used once) rather than flushing the cache for a
        zero-hit-rate resident.
        """
        nbytes = self._nbytes(value)
        with self.lock:
            self._drain_dead()
            hit = self._cache.get(key)
            if hit is not None:
                return hit
            if self._max_bytes is not None and nbytes > self._byte_budget():
                return value
            while self._cache and (
                (self._max_entries is not None and len(self._cache) >= self._max_entries)
                or (self._max_bytes is not None and self._total + nbytes > self._byte_budget())
            ):
                self._evict_one()
            self._cache[key] = value
            self._total += nbytes
            for owner in owners:
                keys = self._owner_keys.get(id(owner))
                if keys is None:
                    self._owner_keys[id(owner)] = [key]
                    weakref.finalize(owner, self._dead_owners.append, id(owner))
                elif key not in keys:
                    keys.append(key)
            return value

    # -- introspection (tests, budget tools) -------------------------------

    @property
    def total_bytes(self) -> int:
        with self.lock:
            self._drain_dead()
            return self._total

    def keys(self) -> list:
        with self.lock:
            self._drain_dead()
            return list(self._cache)

    def values(self) -> list:
        with self.lock:
            self._drain_dead()
            return list(self._cache.values())

    def __len__(self) -> int:
        with self.lock:
            self._drain_dead()
            return len(self._cache)

    def clear(self) -> None:
        with self.lock:
            self._cache.clear()
            self._owner_keys.clear()
            self._dead_owners.clear()
            self._total = 0
