"""Repository-wide test set-up, loaded before ``tests/conftest.py``.

Both packages build a native engine on first use (``<package>/native``).
The JAX package's loader has g++ write its library in place, so an xdist
worker that finds the file half written while another worker builds it
fails to load it, and keeps failing for the rest of its run.  Built once
in the controlling process before the workers start, every worker only
loads it.
"""

import importlib.util
import os


def _build_native_engines():
    """Build both packages' native engines if they are missing or stale.
    Each ``native/__init__.py`` is loaded by its path, so neither package
    is imported here."""
    root = os.path.dirname(os.path.abspath(__file__))
    for package in ("richdem_tpu", "richdem_tpu_torch"):
        spec = importlib.util.spec_from_file_location(
            f"_conftest_{package}_native",
            os.path.join(root, package, "native", "__init__.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        module.available()


def pytest_configure(config):
    # in the controlling process (or the only one), before workers start
    if not hasattr(config, "workerinput"):
        _build_native_engines()
