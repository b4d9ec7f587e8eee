"""Tests of the benchmark.  Run from the repository's root:

    python -m pytest benchmarks/tests -q

Tests marked ``cuda`` need a card; each decides inside the test, through
its module's ``card`` fixture, and skips without one.
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")
