"""GUI support: a headless structural PySide6 stand-in (port of ``gui/``).

The reference front-end is a PySide6 application (reference
GUI_batch_download_plot_FAST.py); where no Qt is installed,
:mod:`.headless_qt` provides the API slice the front-end uses with real
(headless) behavior -- signals, event loop, widget state -- letting
``cli.GUI_batch_download_plot_FAST.run_qt()`` execute and be tested
without a display or Qt install.
"""
