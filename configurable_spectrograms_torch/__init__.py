"""PyTorch/CUDA port of the configurable spectrogram engine.

The JAX package ``configurable_spectrograms_tpu`` stays in the repository
as the reference; this package mirrors its module layout and function
names so each counterpart is easy to find.  It imports ``torch`` and never
``jax``.  The FAST batch runs end to end: the batch driver
(:mod:`.fast.batch_directory`) over a whole archive, with the extrema
pre-pass (:mod:`.fast.extrema`) and the per-orbit render
(:mod:`.fast.process_orbit`), whose pitch collapse and explicit-bounds
quantize run in hand-written CUDA kernels (:mod:`.ops.kernels`, sources in
``csrc/``) on an NVIDIA GPU and in their plain PyTorch versions on the CPU.
The audio front end (:mod:`.ops.stft`, whose ``pallas`` method runs the
STFT-power kernel), the generic single-CDF and batch renders, the CDA
Web downloads (:mod:`.data.download`) and the download / batch-plot /
single-day front end (``cli.GUI_batch_download_plot_FAST``: Qt pages, on
the headless stand-in of :mod:`.gui` where Qt is absent, or ``--tui``;
its actions run in spawned child processes) are ported too.

Layer map:

* ``cli``    -- ``python -m configurable_spectrograms_torch.cli.<name>`` for the
  six root CLIs (the front end among them) and the audio CLI
* ``gui``    -- the headless PySide6 stand-in the front end runs on without Qt
* ``batch_multi_plot_spectrogram`` -- the root re-export shim's names
* ``batch_runner`` / ``generic_batch`` -- resumable batch execution
* ``utils``  -- device selection, logging, progress JSON, percentile helpers,
  ``FastBatchConfig``, stage timing and the profiler trace
* ``data``   -- CDF reader/writer, orbit discovery, synthetic archives
* ``ops``    -- kernels, the audio STFT and the eager-torch panel analysis
* ``render`` -- bucketed dispatch, host backend, figure composition
* ``fast``   -- FAST mission layer (batch driver, extrema pre-pass, per-orbit render)

Importing the package imports no torch and starts no CUDA; it sets one
piece of process-wide allocator state, as the JAX package's import does
(below).
"""

import os as _os

# numpy >= 1.22 madvise(MADV_HUGEPAGE)s every >=4 MB allocation.  On hosts
# with transparent_hugepage=madvise, that routes each fresh figure canvas /
# collapse buffer through 2 MB-page allocation, whose latency under memory
# fragmentation is erratic.  The pipeline reuses its large buffers (canvas
# pool, thread-local encoder scratch), so huge pages buy little; default
# them off unless the user set the knob themselves.  The runtime setter
# covers interpreters where numpy was already imported (e.g. by
# sitecustomize) before this package.  Embedders that do not want an
# import to touch process-global allocator state can opt out with
# CST_HUGEPAGE_TUNING=0 (the override also never runs when
# NUMPY_MADVISE_HUGEPAGE is already set by the user).
if (
    _os.environ.get("CST_HUGEPAGE_TUNING", "1") != "0"
    and "NUMPY_MADVISE_HUGEPAGE" not in _os.environ
):
    _os.environ["NUMPY_MADVISE_HUGEPAGE"] = "0"
    try:
        from numpy._core import multiarray as _ma  # numpy >= 2
    except ImportError:  # pragma: no cover - numpy 1.x
        try:
            from numpy.core import multiarray as _ma
        except ImportError:
            _ma = None
    if _ma is not None:
        try:
            _ma._set_madvise_hugepage(False)
        except (AttributeError, TypeError):  # pragma: no cover
            pass
    del _ma
del _os

__version__ = "0.1.0"
