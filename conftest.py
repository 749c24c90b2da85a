"""Builds the JAX package's native data plane once, before test workers
start.

``virtex_tpu/native`` builds ``_dataplane.so`` at first use with ``g++ -o``
straight to its final path, under a lock that holds within one process
only. Under pytest-xdist every worker that imports a test of the data
plane would start its own ``g++``, and a worker that loads a half-written
file records the error and skips that module's tests. So the controller
(the process without ``workerinput``) builds the library first. It loads
the module by file path, not as ``virtex_tpu.native``, so that importing
the package (and JAX with it) waits for ``tests/conftest.py`` to set
``XLA_FLAGS``.
"""
import importlib.util
import os


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "virtex_tpu", "native", "__init__.py")
    spec = importlib.util.spec_from_file_location("_virtex_tpu_native_build",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.available()
