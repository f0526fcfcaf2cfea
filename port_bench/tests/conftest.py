"""The benchmark's own tests. A test that needs a CUDA device is marked
``card``; it decides inside itself whether there is one, and skips where
there is none."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips where there is none")
