import os

# Tests run single-device (the dry-run sets its own device count in a
# subprocess); keep x64 off and make CPU deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips on a host without one")


# --- optional-hypothesis stand-ins -----------------------------------------
# Property tests degrade to a single skipped test when hypothesis is not
# installed (clean environments must still collect and run the suite).
# Every stub registers itself so the terminal summary reports EXACTLY
# how much property coverage this environment skipped — a silent "all
# green" run that quietly dropped the fuzzers must not look complete
# (the CI tier1-hypothesis job installs the real library and runs them).

SKIPPED_PROPERTY_TESTS: list = []


def settings(**_kw):
    return lambda f: f


def given(*_args, **_kwargs):
    import pytest

    def deco(f):
        SKIPPED_PROPERTY_TESTS.append(f.__name__)

        @pytest.mark.skip(reason="hypothesis not installed")
        def stub():
            pass

        stub.__name__ = f.__name__
        stub.__doc__ = f.__doc__
        return stub

    return deco


class _Strategies:
    """Argument-shape stand-in for hypothesis.strategies."""

    def __getattr__(self, name):
        return lambda *a, **k: None


st = _Strategies()


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    """One greppable line accounting for degraded property coverage:
    ``skipped_property_tests: N`` — 0 when hypothesis is installed (all
    fuzzers actually ran), the stub count when it is not."""
    terminalreporter.write_line(
        f"skipped_property_tests: {len(SKIPPED_PROPERTY_TESTS)}"
        + (f" ({', '.join(sorted(set(SKIPPED_PROPERTY_TESTS)))})"
           if SKIPPED_PROPERTY_TESTS else " (hypothesis installed)"))
