"""Host-compute concurrency gate for feeder-thread pools (port of ``utils/compute_gate.py``).

The device backend sizes its feeder pool for OVERLAP: threads that wait on
the card release the interpreter lock, so more threads than cores pay off
while device work is in flight.  But the host-CPU-bound stages those same
threads run -- compositing, PNG encode -- degrade under oversubscription
(GIL handoffs, several ~35 MB canvases thrashing the cache).  The
reference never faced this split: its process pool ran one figure per
process end to end (reference fast/batch_directory.py:337).

This gate bounds CONCURRENT HOST COMPUTE to the visible core count without
shrinking the pool: at most ``cores`` threads run a gated section at once,
and the rest park on the semaphore.  One slot spans a whole figure render
and its encode (a gated stage alone still loses time to siblings' ungated
Python stealing GIL slices), so the gate is RE-ENTRANT: an outer
``host_compute_gate()`` makes the inner per-stage gates free.
:func:`gate_released` yields the held slot around the one section that
genuinely blocks (a render handed to the coalescer's dispatcher), keeping
the overlap the wide pool exists for.

``CST_HOST_COMPUTE_GATE`` sets the slot count; ``0`` disables.

A copy of the JAX package's module, without its slot leak: a slot is
taken by an explicit ``acquire`` and released only if the thread still
holds it (``_TLS.holds``), so a re-acquire in :func:`gate_released` that
is interrupted (a KeyboardInterrupt while parked) neither over-releases
the semaphore nor mints a phantom slot for the rest of the process.
"""

from __future__ import annotations

import functools
import os
import threading
from contextlib import contextmanager

from configurable_spectrograms_torch.utils.timing import active_stage

_LOCK = threading.Lock()
_GATE: threading.BoundedSemaphore | None = None
_GATE_SLOTS = 0
#: Per thread: ``depth`` of nested gates (only 0 -> 1 acquires), the
#: ``gate`` whose slot the thread took, and whether it ``holds`` it now.
_TLS = threading.local()


def _visible_cores() -> int:
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):  # pragma: no cover - non-Linux
        return max(1, os.cpu_count() or 1)


def _slots() -> int:
    try:
        return int(os.environ.get("CST_HOST_COMPUTE_GATE", _visible_cores()))
    except ValueError:
        return _visible_cores()


def _gate(n: int) -> threading.BoundedSemaphore:
    global _GATE, _GATE_SLOTS
    with _LOCK:
        if _GATE is None or _GATE_SLOTS != n:
            _GATE = threading.BoundedSemaphore(n)
            _GATE_SLOTS = n
        return _GATE


def holds_slot() -> bool:
    """Whether the calling thread holds a gate slot right now."""
    return bool(getattr(_TLS, "holds", False))


@contextmanager
def host_compute_gate():
    """Bound this block's concurrency to the slot count (re-entrant per thread).

    Wrap CPU-bound sections only; never hold a slot across a wait on the
    device -- inside a gated scope, bracket the wait with
    :func:`gate_released`.  A zero or negative slot count disables gating.
    """
    n = _slots()
    if n <= 0:
        yield
        return
    depth = getattr(_TLS, "depth", 0)
    if depth:
        # An outer gate of this thread spans this section.
        _TLS.depth = depth + 1
        try:
            yield
        finally:
            _TLS.depth = depth
        return
    gate = _gate(n)
    with active_stage("gate_wait"):
        gate.acquire()
    _TLS.depth, _TLS.gate, _TLS.holds = 1, gate, True
    try:
        yield
    finally:
        held = _TLS.holds
        _TLS.depth, _TLS.gate, _TLS.holds = 0, None, False
        if held:
            gate.release()


def gated(fn):
    """Run *fn* under :func:`host_compute_gate` (free when the caller already holds a slot)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with host_compute_gate():
            return fn(*args, **kwargs)

    return wrapper


@contextmanager
def gate_released():
    """Yield this thread's held slot for the duration of a genuinely blocking wait.

    The slot goes back to the same semaphore object, and is re-acquired
    from it -- even if the slot count was retuned meanwhile -- before the
    gated work resumes.  A no-op when the thread holds no slot.  If the
    re-acquire is interrupted, the thread leaves holding nothing, and the
    enclosing gate releases nothing.
    """
    depth = getattr(_TLS, "depth", 0)
    gate = getattr(_TLS, "gate", None)
    if not depth or gate is None or not holds_slot():
        yield
        return
    _TLS.depth, _TLS.gate, _TLS.holds = 0, None, False
    gate.release()
    try:
        yield
    finally:
        with active_stage("gate_wait"):
            gate.acquire()
        _TLS.depth, _TLS.gate, _TLS.holds = depth, gate, True
