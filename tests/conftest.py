import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel; skips where there is no card")


class _FakeStrategies:
    """Stands in for hypothesis.strategies when hypothesis is absent: any
    strategy constructor returns None (the @given stub ignores them)."""

    def __getattr__(self, name):
        return lambda *a, **k: None


def optional_hypothesis():
    """Returns ``(given, settings, st)``.

    With hypothesis installed these are the real decorators; without it the
    property tests are collected but individually *skipped* (instead of the
    pre-PR-1 behaviour, where the bare import failed the whole module's
    collection and took every plain unit test in it down too).  Install the
    pinned dev deps with ``pip install -r requirements-dev.txt``.
    """
    try:
        from hypothesis import given, settings, strategies as st
        return given, settings, st
    except ImportError:
        def given(*a, **k):
            def deco(fn):
                import functools

                @functools.wraps(fn)
                def stub(*args, **kwargs):
                    pass
                return pytest.mark.skip(
                    reason="hypothesis not installed "
                           "(pip install -r requirements-dev.txt)")(stub)
            return deco

        def settings(*a, **k):
            return lambda fn: fn

        return given, settings, _FakeStrategies()
