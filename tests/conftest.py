"""Shared fixtures. NOTE: no XLA_FLAGS here — tests run on 1 CPU device by
design (the 512-device override belongs exclusively to launch/dryrun.py)."""
import os

import numpy as np
import pytest

os.environ.setdefault("REPRO_PALLAS_INTERPRET", "1")  # kernels: interpret mode

# Hypothesis depth is profile-driven: the default `ci` profile keeps the
# PR-gate suite fast, the `nightly` profile (selected by the scheduled CI
# job via HYPOTHESIS_PROFILE=nightly) runs an order of magnitude more
# examples. No property test pins its own max_examples — a per-test
# @settings would silently override the profile and opt out of the
# nightly deepening.
try:
    from hypothesis import HealthCheck, settings

    _COMMON = dict(deadline=None,
                   suppress_health_check=[HealthCheck.too_slow])
    settings.register_profile("ci", max_examples=25, **_COMMON)
    settings.register_profile("nightly", max_examples=300, **_COMMON)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))
except ImportError:                               # tier-1 runs without it
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (training loops, LLM serving); "
        "deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and nvcc (the PyTorch port's kernels); "
        "skips itself elsewhere — run with -m cuda on the card")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def small_graph():
    from repro.data.graphs import planetoid_like
    return planetoid_like(num_nodes=220, num_edges=500, num_feats=48,
                          num_classes=5, seed=1)


@pytest.fixture(scope="session")
def padded_graph(small_graph):
    from repro.core.graph import pad_graph
    return pad_graph(small_graph)
