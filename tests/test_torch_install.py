"""The port as an installed package, and its import-time allocator policy, on the CPU.

* Build location: both native libraries (``ops._build``'s CUDA kernels and
  ``render.fastpng``'s encoder) build into ``ops._build.cache_dir()``:
  ``CST_NATIVE_CACHE_DIR`` when set, ``build/cst_torch/`` in a source
  checkout, else ``$HOME/.cache/configurable_spectrograms_torch``.  A copy
  of the package in a ``site/`` directory without ``pyproject.toml``
  (byte-compiled, as ``pip install`` leaves it) renders a figure on the
  CPU: g++ builds the encoder into the per-user cache and nothing in the
  copy's tree changes.
* Allocator policy: importing the package sets ``NUMPY_MADVISE_HUGEPAGE=0``
  and turns numpy's hugepage madvise off, unless the user set that
  variable or ``CST_HUGEPAGE_TUNING=0``, as importing the JAX package does;
  the import still imports no torch.
"""

import compileall
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT, JAX = "configurable_spectrograms_torch", "configurable_spectrograms_tpu"


def test_cache_dir_is_the_env_knob_then_the_checkout(monkeypatch, tmp_path):
    from configurable_spectrograms_torch.ops import _build
    from configurable_spectrograms_torch.render import fastpng

    monkeypatch.delenv("CST_NATIVE_CACHE_DIR", raising=False)
    assert _build.cache_dir() == REPO / "build" / "cst_torch"
    monkeypatch.setenv("CST_NATIVE_CACHE_DIR", str(tmp_path / "cache"))
    assert _build.cache_dir() == tmp_path / "cache"
    assert _build.library_path().parent == fastpng.library_path().parent == tmp_path / "cache"


def _installed_copy(tmp_path: Path) -> Path:
    """The package alone in ``tmp_path/site`` (no pyproject.toml there), byte-compiled as pip leaves it."""
    site = tmp_path / "site"
    shutil.copytree(REPO / PORT, site / PORT, ignore=shutil.ignore_patterns("__pycache__"))
    assert compileall.compile_dir(str(site), quiet=1)
    return site


def _listing(root: Path) -> dict[str, tuple[int, int]]:
    return {str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns) for p in sorted(root.rglob("*"))}


def _installed_env(site: Path, home: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(site), HOME=str(home), CST_TORCH_DEVICE="cpu", CST_RENDER_BACKEND="device")
    env.pop("CST_NATIVE_CACHE_DIR", None)
    return env


def test_installed_copy_builds_into_the_user_cache_and_leaves_its_tree_alone(tmp_path):
    from configurable_spectrograms_torch.data.synthetic import synth_fast_cdf

    site, home = _installed_copy(tmp_path), tmp_path / "home"
    home.mkdir()
    cdf = str(tmp_path / "ees.cdf")
    synth_fast_cdf(cdf, 4100, "ees", n_time=64, n_angle=8, n_energy=16)
    before = _listing(site)
    env = _installed_env(site, home)
    where = subprocess.run(
        [sys.executable, "-c", "import json; from configurable_spectrograms_torch.ops import _build; "
         "from configurable_spectrograms_torch.render import fastpng; "
         "print(json.dumps([_build.__file__, str(_build.cache_dir()), str(_build.library_path().parent), "
         "str(fastpng.library_path().parent)]))"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert where.returncode == 0, where.stderr
    module, *dirs = json.loads(where.stdout)
    cache = home / ".cache" / PORT
    assert Path(module).is_relative_to(site) and dirs == [str(cache)] * 3

    out = tmp_path / "figure.png"
    render = subprocess.run(
        [sys.executable, "-m", f"{PORT}.cli.single_plot_spectrogram", "--cdf-file", cdf, "--output", str(out)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert render.returncode == 0, render.stdout + render.stderr
    assert out.stat().st_size > 0
    assert len(list(cache.glob("libfastpng-*.so"))) == 1
    assert not list(cache.glob("*.tmp*"))  # the build's temporary was moved into place
    assert _listing(site) == before


#: Each case: the environment the interpreter starts with, and what importing either package must leave.
HUGEPAGE_CASES = {
    "default": ({}, "0", False),
    "user_set": ({"NUMPY_MADVISE_HUGEPAGE": "1"}, "1", True),
    "tuning_off": ({"CST_HUGEPAGE_TUNING": "0"}, None, "numpy's default"),
}
PROBE = (
    "import json, os, sys; import {pkg}; from numpy._core import multiarray; "
    "print(json.dumps([os.environ.get('NUMPY_MADVISE_HUGEPAGE'), multiarray._get_madvise_hugepage(), "
    "'torch' in sys.modules, 'jax' in sys.modules]))"
)


def _probe(pkg: str | None, extra: dict) -> list:
    env = {k: v for k, v in os.environ.items() if k not in ("NUMPY_MADVISE_HUGEPAGE", "CST_HUGEPAGE_TUNING")}
    env.update(extra, PYTHONPATH=str(REPO))
    code = PROBE.format(pkg=pkg) if pkg else PROBE.replace("import {pkg}; ", "")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


@pytest.mark.parametrize("case", list(HUGEPAGE_CASES))
def test_import_applies_the_jax_packages_hugepage_policy(case):
    env, want_var, want_madvise = HUGEPAGE_CASES[case]
    if want_madvise == "numpy's default":
        want_madvise = _probe(None, {})[1]
    port = _probe(PORT, env)
    assert port == [want_var, want_madvise, False, False]  # and no torch (nor jax) imported
    assert _probe(JAX, env)[:2] == port[:2]
