"""pytest settings of the benchmark's own tests (``bench/test_bench_*.py``).

Imports no JAX. The ``cuda`` marker names the tests that need the card;
each decides inside the test whether one is there."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips on a host without one")
