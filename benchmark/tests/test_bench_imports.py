"""Nothing the benchmark runs imports JAX or the JAX package; the reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

from bench_helpers import BENCH, FORBIDDEN, ROOT


def _imported_top_names(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        found = _imported_top_names(path) & set(FORBIDDEN)
        assert not found, f"{path.relative_to(ROOT)} imports {found}"


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "configurable_spectrograms_torch" not in _imported_top_names(path), path.name


def test_the_check_compares_whole_top_level_names(monkeypatch):
    """The port's name begins with the JAX package's; only a whole top-level name counts."""
    import types

    import run

    monkeypatch.setitem(sys.modules, "configurable_spectrograms_torch.probe", types.ModuleType("probe"))
    monkeypatch.setitem(sys.modules, "jax_adjacent_name", types.ModuleType("jax_adjacent_name"))
    assert run.forbidden_modules() == []


def test_a_run_leaves_no_jax_in_sys_modules(tmp_path):
    """A tiny run in a fresh interpreter prints its result: the harness's own check found no JAX."""
    script = (
        f"import os, sys; os.environ['CST_TORCH_DEVICE'] = 'cpu'; sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
        "from bench_helpers import run_cell, FORBIDDEN\n"
        "if __name__ == '__main__':\n"
        "    code, result = run_cell('fast_esa_l2.sample_orbits')\n"
        "    found = sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))\n"
        "    print('RESULT', code, result is not None and result['correct'], found)\n"
    )
    probe = tmp_path / "probe_run.py"
    probe.write_text(script)
    done = subprocess.run([sys.executable, str(probe)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    last = [line for line in done.stdout.splitlines() if line.startswith("RESULT")]
    assert last == ["RESULT 0 True []"], done.stdout[-2000:] + done.stderr[-2000:]


def test_the_harness_refuses_a_process_that_imported_jax(monkeypatch):
    import types

    import run

    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    assert run.forbidden_modules() == ["jaxlib"]
