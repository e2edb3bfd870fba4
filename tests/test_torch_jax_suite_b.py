"""The second half of the JAX package's test suite against the port (see tests/test_torch_jax_suite.py).

Its own child run, so that no one worker of a parallel tier-1 run carries the
whole suite.
"""

import pytest
from test_torch_jax_suite import SHARDS, assert_isolated, assert_passed, pass_cases, run_staged, stray_not_applicable


@pytest.fixture(scope="module")
def suite(tmp_path_factory) -> dict:
    return run_staged(tmp_path_factory.mktemp("jax_suite_b"), list(SHARDS["b"]), device="cpu", timeout=900)


@pytest.mark.parametrize("func", pass_cases("b"))
def test_jax_test_passes_on_the_port(func, suite):
    assert_passed(suite, func)


def test_not_applicable_tests_do_not_pass(suite):
    assert not stray_not_applicable(suite, SHARDS["b"]), "these pass now: move them to PASS"


def test_no_staged_process_loaded_jax_or_the_jax_package(suite):
    assert_isolated(suite)
    argvs = [" ".join(proc[0]["argv"]) for proc in suite["processes"] if proc and proc[0]["kind"] == "start"]
    assert any("spawn_main" in a for a in argvs), argvs
