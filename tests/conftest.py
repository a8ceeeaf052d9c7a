"""Shared fixtures + the custom markers, registered in one place.

Collection must never hard-fail on missing dev-only deps: modules using
hypothesis (see requirements-dev.txt) begin with
``pytest.importorskip("hypothesis")`` so they collect as skipped when the
dep is absent. ``scripts/verify.sh`` runs a collect-only smoke to enforce a
clean import graph.

Markers (all registered here so ``pytest --strict-markers`` passes):

``multidevice`` marks tests that need a real multi-device mesh (≥ 4 jax
devices). The blocking CI ``multidevice`` job runs them in-process under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``; in a single-device
session they auto-skip (the subprocess fallbacks in ``test_dist.py`` /
``test_shard.py`` keep the coverage). The device count is read lazily so
collection itself never initializes the jax backend.

``integration`` marks black-box server tests that spawn the
``repro.launch.server`` subprocess (train + compile + socket traffic —
minutes, not seconds). They are excluded from tier-1: the blocking CI
``integration`` job opts in with ``REPRO_INTEGRATION=1``; a plain local
``pytest`` run skips them.

``hyp_examples`` scales every hypothesis ``max_examples`` by
``REPRO_HYPOTHESIS_SCALE`` (default 1): per-PR CI keeps the counts tuned
for latency, the scheduled nightly workflow (.github/workflows/nightly.yml)
sets the scale to 10 for a deep property sweep. A helper function (not a
profile) because per-test ``@settings(max_examples=...)`` would override
any profile default.
"""
import os

import numpy as np
import pytest


def hyp_examples(n: int) -> int:
    """``n`` hypothesis examples, scaled by ``REPRO_HYPOTHESIS_SCALE``."""
    return n * max(int(os.environ.get("REPRO_HYPOTHESIS_SCALE", "1")), 1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidevice: needs >= 4 jax devices (run under "
        "XLA_FLAGS=--xla_force_host_platform_device_count=4)")
    config.addinivalue_line(
        "markers",
        "integration: spawns the serving subprocess (run with "
        "REPRO_INTEGRATION=1)")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card; a fixture in the test decides and skips "
        "when there is none")


def pytest_runtest_setup(item):
    if item.get_closest_marker("multidevice") is not None:
        import jax
        n = jax.device_count()
        if n < 4:
            pytest.skip(f"needs >= 4 jax devices, have {n} (set XLA_FLAGS="
                        "--xla_force_host_platform_device_count=4)")
    if item.get_closest_marker("integration") is not None \
            and not os.environ.get("REPRO_INTEGRATION"):
        pytest.skip("integration test (set REPRO_INTEGRATION=1 to run)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
