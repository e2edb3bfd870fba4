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
"""

__version__ = "0.1.0"
