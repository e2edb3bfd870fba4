"""The port's orbit-major batch driver, error taxonomy and timeout retry against the JAX package's, on the CPU.

The fixtures of tests/test_torch_batch.py: one tiny synthetic archive (2
orbits, 2 instruments), the JAX package on its host backend as the
reference, ``max_workers=1`` so completion order is deterministic.
"""

import shutil

import pytest
import torch
from test_torch_batch import ORBITS, RUN, _assert_same_trees, _pngs, _run, archive, jax_reference, port

torch.set_num_threads(1)

__all__ = ["archive", "jax_reference", "port"]  # fixtures shared with tests/test_torch_batch.py


@pytest.mark.parametrize("backend", ["host", "device"])
def test_multi_driver_matches_the_jax_package_and_resumes(backend, archive, jax_reference, port, tmp_path):
    from configurable_spectrograms_tpu.fast.batch_directory import FAST_plot_spectrograms_multi as jmulti

    from configurable_spectrograms_torch.fast.batch_directory import FAST_plot_spectrograms_multi

    port(backend)
    kw = dict(RUN, combos=(("linear", "linear", "inferno"), ("log", "log", "inferno")))
    want = jax_reference("FAST_plot_spectrograms_multi", **kw)
    got = _run(FAST_plot_spectrograms_multi, archive["data"], tmp_path, **kw)
    assert got["results"] == want["results"]
    assert len(got["pngs"]) == 2 * 2 * 2 * 3  # combos x orbits x given/raw x 3 figures
    _assert_same_trees(got["pngs"], want["pngs"], backend)
    assert got["progress"] == want["progress"]
    assert got["extrema"] == want["extrema"]
    # Resuming finds nothing to do in either package.
    for driver, run in ((FAST_plot_spectrograms_multi, got), (jmulti, want)):
        out = run["out"]
        assert driver(archive["data"], output_base=str(out / "plots"), progress_json_path=str(out / "progress.json"),
                      extrema_json_path=str(out / "extrema.json"), **kw) == []
        assert _pngs(out / "plots") == run["pngs"]


@pytest.fixture(scope="module")
def broken_archive(archive):
    """The archive with orbit 4100's ees file cut to 100 bytes."""
    data = archive["root"] / "broken"
    if not data.exists():
        shutil.copytree(archive["data"], data)
        bad = next(data.rglob("*_ees_*_4100_*.cdf"))
        bad.write_bytes(bad.read_bytes()[:100])
    return str(data)


def test_error_taxonomy_matches_the_jax_package(broken_archive, jax_reference, port, tmp_path):
    """A truncated ees file: the same results and progress keys as the JAX package (tests/test_fast_layer.py:244-276)."""
    from configurable_spectrograms_torch.fast.batch_directory import FAST_plot_spectrograms_directory

    port("host")
    kw = dict(RUN, max_processing_percentile=None, y_scale="linear", z_scale="linear", flush_batch_size=1)
    want = jax_reference("FAST_plot_spectrograms_directory", data=broken_archive, **kw)
    got = _run(FAST_plot_spectrograms_directory, broken_archive, tmp_path, **kw)
    assert {r["orbit"]: r["status"] for r in got["results"]} == {4100: "error", 4101: "ok"}
    assert got["results"] == want["results"]
    assert got["progress"] == want["progress"]
    assert got["progress"]["linear_linear_error_plotting"] == [4100]
    assert any(k.startswith("ees_linear_linear_error-") for k in got["progress"])
    assert list(got["pngs"]) == list(want["pngs"])


def test_timeout_keys_and_retry_match_the_jax_package(archive, jax_reference, port, tmp_path):
    """``instrument_timeout_seconds=0`` times every orbit out after its first instrument; the retry pass does too."""
    from configurable_spectrograms_torch.fast.batch_directory import FAST_plot_spectrograms_directory

    port("host")
    kw = dict(RUN, max_processing_percentile=None, y_scale="log", z_scale="linear", flush_batch_size=1,
              instrument_timeout_seconds=0, retry_timeouts=True)
    want = jax_reference("FAST_plot_spectrograms_directory", **kw)
    got = _run(FAST_plot_spectrograms_directory, archive["data"], tmp_path, **kw)
    assert [(r["status"], r["timeout_type"], r["timeout_instrument"]) for r in got["results"]] == [
        ("timeout", "instrument", "ees")] * 2
    assert got["results"] == want["results"]
    assert got["progress"] == want["progress"]
    assert got["progress"]["ees_log_linear_timed_out"] == ORBITS
