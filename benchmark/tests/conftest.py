"""The benchmark's own tests: the repository root on ``sys.path`` (so
``benchmark`` imports as a package) and the ``card`` marker, for tests
that need a CUDA card and skip without one (decided inside each test)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")
