"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests -q``): the benchmark's folder and the repository's root on
the import path, and the ``card`` marker. A test marked ``card`` needs an
NVIDIA card; it decides inside itself whether one is present and skips
where there is none."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0 if p == str(HERE) else len(sys.path), p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips where there is none")
