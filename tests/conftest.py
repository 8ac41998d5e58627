import os
import sys
import types

# tests run on the single real CPU device (the dry-run sets its own flags in
# a subprocess); keep compilation deterministic and quiet
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# ---------------------------------------------------------------------------
# hypothesis fallback: several test modules use property-based tests. When
# hypothesis is unavailable (it is not baked into the runtime image), install
# a stub so collection succeeds and @given tests skip instead of erroring.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    import pytest

    class _Anything:
        """Stands in for strategy builders: any call/attr returns itself."""

        def __call__(self, *args, **kwargs):
            return self

        def __getattr__(self, name):
            return self

    def _given(*_args, **_kwargs):
        def deco(fn):
            return pytest.mark.skip(
                reason="hypothesis not installed (see requirements-dev.txt)"
            )(fn)
        return deco

    def _settings(*_args, **_kwargs):
        def deco(fn):
            return fn
        return deco

    stub = types.ModuleType("hypothesis")
    stub.given = _given
    stub.settings = _settings
    stub.strategies = _Anything()
    stub.__version__ = "0.0-stub"
    sys.modules["hypothesis"] = stub
    sys.modules["hypothesis.strategies"] = stub.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips with a reason elsewhere")
