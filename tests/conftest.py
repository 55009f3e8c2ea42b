"""Pytest bootstrap: make tests/ importable regardless of import mode
(``_hypothesis_compat`` is shared by the property-test modules), and
register hypothesis profiles sized for CPU runners.

Profiles (selected via ``HYPOTHESIS_PROFILE``, default ``dev``):

* ``dev`` — a handful of examples; keeps the local tier-1 loop fast.
* ``ci`` — the Actions job's budget: more examples, no deadline (CPU
  runners jit-compile on the first example, which would trip any
  per-example deadline).
"""
import os
import pathlib
import sys

_HERE = str(pathlib.Path(__file__).resolve().parent)
if _HERE not in sys.path:
    sys.path.insert(0, _HERE)

import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop jit/pjit executable caches after each test module.

    The suite compiles hundreds of distinct XLA:CPU programs (per-shape
    engines, Pallas interpret traces, dense references); keeping every
    executable alive for the whole session eventually segfaults the
    XLA CPU compiler on small runners. Per-module clearing bounds the
    live-executable set without recompiling within a module.
    """
    yield
    import jax

    jax.clear_caches()


try:
    from hypothesis import HealthCheck, settings

    _COMMON = dict(
        deadline=None,
        suppress_health_check=[HealthCheck.too_slow],
    )
    # dev: fixed examples for a fast, reproducible local loop; ci: fresh
    # draws every run — replaying one frozen example set forever would
    # make the "CI fuzzes the state machine" claim hollow (failures print
    # a @reproduce_failure blob for replay)
    settings.register_profile("dev", max_examples=5, derandomize=True,
                              **_COMMON)
    settings.register_profile("ci", max_examples=25, print_blob=True,
                              **_COMMON)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "dev"))
except ModuleNotFoundError:  # property tests skip via _hypothesis_compat
    pass


def pytest_configure(config):
    # tests of the port's CUDA kernels: they skip without an NVIDIA GPU
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (CUDA kernels of repro_torch)")
