"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository root (``-m cuda`` on a machine with a card). The harness's
packages (``harness``, ``refimpl``) live under ``benchmark/``."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
