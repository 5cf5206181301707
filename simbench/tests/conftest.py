"""simbench's own tests (``python -m pytest simbench/tests -q``); tests that
need the card are marked ``cuda`` and skip without one, deciding inside the
test."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")
