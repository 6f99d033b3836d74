"""The benchmark's own tests: CPU tests hold its copies, its reference and
its runs at tiny sizes; tests marked `card` run on the card and skip
without one (they decide inside the test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
