"""The port's doctests, one case per module that has examples.

The port's counterpart of ``tests/test_doctests.py`` (which runs
``pre_commit_hooks/run_doctests.py`` over the JAX package): every module of
``configurable_spectrograms_torch`` whose source holds a ``>>>`` is
imported and run through ``doctest.testmod`` with ``CST_TORCH_DEVICE=cpu``.
A module that stops importing fails its case.
"""

import doctest
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = "configurable_spectrograms_torch"


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(REPO).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


MODULES = sorted(_module_name(p) for p in (REPO / PACKAGE).rglob("*.py") if ">>>" in p.read_text())


def test_the_port_has_doctests():
    assert len(MODULES) >= 9, MODULES


@pytest.mark.parametrize("name", MODULES)
def test_module_doctests_pass(name, monkeypatch):
    """test_doctests.py::test_doctest_harness_passes: every module's examples run, none fails."""
    monkeypatch.setenv("CST_TORCH_DEVICE", "cpu")
    module = importlib.import_module(name)
    results = doctest.testmod(module, verbose=False, report=True)
    assert results.attempted > 0, f"{name} holds '>>>' but no doctest ran"
    assert results.failed == 0, f"{results.failed} of {results.attempted} doctests failed in {name}"
