"""Shared test fixtures and optional-dependency shims.

``hypothesis`` is not part of the pinned container image; when it is
absent we alias the deterministic stub in ``repro.testing.hypothesis_stub``
so property tests still collect and run (with seeded, reproducible
examples).  A real hypothesis installation always wins.
"""

import importlib.util
import sys
import types


def _install_hypothesis_stub() -> None:
    if importlib.util.find_spec("hypothesis") is not None:
        return
    from repro.testing import hypothesis_stub

    module = types.ModuleType("hypothesis")
    module.given = hypothesis_stub.given
    module.settings = hypothesis_stub.settings
    module.HealthCheck = hypothesis_stub.HealthCheck
    module.strategies = hypothesis_stub
    module.__stub__ = True
    sys.modules["hypothesis"] = module
    sys.modules["hypothesis.strategies"] = hypothesis_stub


_install_hypothesis_stub()


def pytest_configure(config) -> None:
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips (inside the test) where CUDA is "
        "absent",
    )
