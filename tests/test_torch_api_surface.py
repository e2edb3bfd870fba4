"""The port's public library API against the JAX package's.

Every public name of the JAX package -- each subpackage's ``__all__`` and
each module's own public functions and classes -- must resolve at the same
path in the port, except the names left out on purpose (:data:`LEFT_OUT`,
each with its reason) and the kernel wrappers of ``ops/pallas_kernels.py``,
whose counterparts live in ``ops/kernels.py`` under other names
(:data:`RENAMED`).  An exception that the port no longer needs fails the
test.  The four filled ``__init__`` files must also import, and every name
they export resolve, with ``jax`` blocked, without importing PIL or pandas
and without starting CUDA.
"""

import importlib
import importlib.util
import inspect
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("jax")

import configurable_spectrograms_tpu  # noqa: E402
from test_torch_slice import BLOCK_JAX  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = "configurable_spectrograms_tpu", "configurable_spectrograms_torch"
SUBPACKAGES = ("ops", "render", "data", "utils")

#: JAX paths (relative to the package: a module, or a module's name) the port leaves out, with the reason.
LEFT_OUT = {
    "utils.jax_setup": "the XLA compilation cache and the machine fingerprint that keys its directory; "
                       "torch compiles no programs to cache (the CUDA kernels build once into build/cst_torch/)",
    "ops._enable_cache": "turns on the XLA compilation cache at import (utils.jax_setup)",
    "render.link": "rule 5: the TPU link probes, soft caps and calibration; a PCIe card needs none "
                   "(render.backend keeps recommended_workers)",
    "render.device_results": "rule 5: the resident result cache of the TPU relay",
    "ops.extrema_ops.sorted_bincount": "rule 5: a TPU workaround for scatter-add; the port uses torch.bincount",
    "parallel.extrema.shard_map": "a JAX version shim for shard_map; torch.distributed has no counterpart",
    "render.fastpng.native_available": "the port has no fallback encoder: fastpng.library() raises when the "
                                       "build fails, and a boolean probe would invite a quiet fallback",
    "render.fastpng.blit_available": "as native_available: the port's blit is always built with the encoder",
    "render.fastpng.blend_available": "as native_available: the port's blend is always built with the encoder",
}

#: JAX names whose port counterpart has another path.
RENAMED = {
    "ops.pallas_kernels.collapse_cube_pallas": "ops.kernels.collapse_lanes",
    "ops.pallas_kernels.fused_quantize_pallas": "ops.kernels.fused_quantize_lanes",
    "ops.pallas_kernels.stft_power_pallas": "ops.kernels.stft_power",
}

JAX_MODULES = sorted(
    m.name[len(JAX) + 1:] for m in pkgutil.walk_packages(configurable_spectrograms_tpu.__path__, JAX + ".")
)


def _public_names(module) -> set[str]:
    """``__all__`` and the public functions and classes *module* defines itself."""
    names = set(getattr(module, "__all__", ()))
    for name, value in vars(module).items():
        if name.startswith("_"):
            continue
        if (inspect.isfunction(value) or inspect.isclass(value)) and value.__module__ == module.__name__:
            names.add(name)
    return names


def _resolve(path: str):
    """The object at *path* (``module.name`` relative to the port), or None where it does not resolve."""
    module, _, name = path.rpartition(".")
    try:
        return getattr(importlib.import_module(f"{PORT}.{module}"), name)
    except (ImportError, AttributeError):
        return None


def _port_module_exists(rel: str) -> bool:
    try:
        return importlib.util.find_spec(f"{PORT}.{rel}") is not None
    except ImportError:
        return False


@pytest.mark.parametrize("rel", [m for m in JAX_MODULES if m not in LEFT_OUT])
def test_public_names_resolve_in_the_port(rel):
    module = importlib.import_module(f"{JAX}.{rel}")
    missing = []
    for name in sorted(_public_names(module)):
        path = f"{rel}.{name}"
        if path in LEFT_OUT:
            continue
        if _resolve(RENAMED.get(path, path)) is None:
            missing.append(RENAMED.get(path, path))
    assert not missing, f"{PORT}: {missing} do not resolve"


@pytest.mark.parametrize("path", sorted(LEFT_OUT))
def test_each_exception_is_still_needed(path):
    """The JAX side has it; the port does not.  An exception the port has outgrown fails here."""
    mod, _, name = path.rpartition(".")
    if f"{mod}.{name}" in JAX_MODULES:
        assert not _port_module_exists(path), f"{PORT}.{path} exists now: drop it from LEFT_OUT"
        return
    assert hasattr(importlib.import_module(f"{JAX}.{mod}"), name), f"{JAX}.{path} is gone"
    if name.startswith("_"):  # a private name is no export of the JAX package's __all__ either
        assert name not in importlib.import_module(f"{JAX}.{mod}").__all__
    assert _resolve(path) is None, f"{PORT}.{path} resolves now: drop it from LEFT_OUT"


@pytest.mark.parametrize("path", sorted(RENAMED))
def test_renamed_kernel_wrappers(path):
    assert callable(getattr(importlib.import_module(f"{JAX}.{path.rpartition('.')[0]}"), path.rpartition(".")[2]))
    assert callable(_resolve(RENAMED[path]))
    assert not _port_module_exists(path.rpartition(".")[0])


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_all_matches_the_jax_package(sub):
    jax_all = importlib.import_module(f"{JAX}.{sub}").__all__
    port = importlib.import_module(f"{PORT}.{sub}")
    assert sorted(port.__all__) == sorted(jax_all)
    for name in port.__all__:
        value = getattr(port, name)
        assert getattr(value, "__module__", PORT).startswith(PORT), f"{sub}.{name} comes from {value.__module__}"


def test_dispatch_render_has_one_name():
    """``device_render_panels`` is the synchronous dispatch render, re-exported as the JAX package does."""
    from configurable_spectrograms_torch import render
    from configurable_spectrograms_torch.render import device_cache, dispatch, drain, figure, panel

    assert not hasattr(dispatch, "render_panels")
    assert render.device_render_panels is figure.device_render_panels is dispatch.device_render_panels
    assert figure.enqueue_render_panels is dispatch.enqueue_render_panels
    assert figure.PendingRender is drain.PendingRender
    assert dispatch.upload_telemetry is device_cache.upload_telemetry
    assert drain.build_panel_result is panel.build_panel_result


_EXPORTS_BLOCKED = BLOCK_JAX + textwrap.dedent(
    """
    import importlib, json

    subs = ("ops", "render", "data", "utils")
    pkgs = [importlib.import_module("configurable_spectrograms_torch." + s) for s in subs]
    after_import = sorted(m for m in ("torch", "PIL", "pandas") if m in sys.modules)
    resolved = sum(getattr(p, n) is not None for p in pkgs for n in p.__all__)
    import torch

    print(json.dumps({
        "after_import": after_import,
        "resolved": resolved,
        "heavy": sorted(m for m in ("PIL", "pandas") if m in sys.modules),
        "cuda_initialized": torch.cuda.is_initialized(),
        "jax": sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "configurable_spectrograms_tpu")),
    }))
    """
)


def test_exports_import_with_jax_blocked():
    import json

    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("CST_TORCH_DEVICE", None)  # the default device: importing must not touch it
    proc = subprocess.run([sys.executable, "-c", _EXPORTS_BLOCKED], capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    n_names = sum(len(importlib.import_module(f"{JAX}.{s}").__all__) for s in SUBPACKAGES)
    assert got == {"after_import": [], "resolved": n_names, "heavy": [], "cuda_initialized": False, "jax": []}
