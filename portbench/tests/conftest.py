"""The benchmark's CPU tests: the manifest, the counts, the references,
the guard, the last line, and the faults and control at a small size.
Run from the root of the checkout: ``python -m pytest -q portbench/tests``
(``-m cuda`` on a card runs the control at the cells' own sizes)."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
