"""The benchmark's test helpers know each cell's driver by name
(``tests/small.py``'s sizes, ``faults.FAULTS``, ``calibrate``'s control);
this adds the Zamba2 cells' driver, ``hybrid_train``, to them before the
tests are collected, so that the tests parametrized over every cell of
``BENCHMARK.json`` run it at its own small size, with its own faults and
control, and every other cell as before."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import calibrate_hybrid  # noqa: E402
from portbench.tests import small, small_zamba2  # noqa: E402

calibrate_hybrid.register()
_resize = small.resize


def _resize_any(cell) -> None:
    if cell.traffic["driver"] == calibrate_hybrid.DRIVER:
        small_zamba2.resize(cell)
    else:
        _resize(cell)


small.resize = _resize_any
