"""Settings of the benchmark's own tests (run with `pytest portbench/tests`).

The `cuda` marker names the tests that need an NVIDIA card; each decides
inside the test whether one is there and skips otherwise."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")
