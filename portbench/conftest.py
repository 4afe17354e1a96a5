"""pytest settings of the benchmark's own tests (``pytest portbench/tests``).

The ``card`` marker is for tests that need a CUDA card; each decides inside
the test whether one is present and skips with a reason when not."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
