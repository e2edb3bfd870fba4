"""The port's paced page-cache writeback (``utils/writeback.py``): the four cases of tests/test_writeback.py."""

import os
import time

import numpy as np
from PIL import Image

from configurable_spectrograms_torch.utils import writeback


def test_note_written_fsyncs_file(tmp_path):
    p = tmp_path / "a.bin"
    p.write_bytes(b"x" * 4096)
    writeback.note_written(str(p))
    deadline = time.monotonic() + 5.0
    while writeback._state["q"] is not None and not writeback._state["q"].empty():
        assert time.monotonic() < deadline, "pacer never drained"
        time.sleep(0.01)
    assert p.read_bytes() == b"x" * 4096


def test_note_written_missing_file_is_harmless(tmp_path):
    writeback.note_written(str(tmp_path / "never-existed.png"))  # no raise


def test_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.setenv("CST_WRITEBACK_PACE", "0")
    before = writeback._state["q"]
    writeback.note_written(str(tmp_path / "x.png"))
    assert writeback._state["q"] is before  # no thread spun up


def test_save_image_routes_through_pacer(tmp_path, monkeypatch):
    from configurable_spectrograms_torch.render.figure import save_image

    seen = []
    monkeypatch.setattr(writeback, "note_written", seen.append)
    img = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
    out = str(tmp_path / "fig.png")
    save_image(img, out)
    assert seen == [out]
    assert os.path.getsize(out) > 0


def test_copied_png_joins_the_pacer(tmp_path, monkeypatch):
    """The given/raw pair's byte copy (process_orbit._copy_saved_png) is queued like a save, as in the JAX package."""
    from configurable_spectrograms_torch.fast.process_orbit import _copy_saved_png

    seen = []
    monkeypatch.setattr(writeback, "note_written", seen.append)
    src, dst = tmp_path / "a.png", tmp_path / "b.png"
    src.write_bytes(b"png bytes")
    _copy_saved_png(str(src), str(dst))
    assert seen == [str(dst)] and dst.read_bytes() == b"png bytes"
