"""The tests written for the POBP driver (``pbtiny.py``: its faults, its
result lines, the record's POBP readers, its tiny specs) run over the
cells that driver drives, the traffic's ``"driver": "train"``; the LM
cells (``"driver": "lm_train"``) have their own (``test_portbench_lm.py``,
``lmtiny.py``).  Their cases for other drivers are deselected here."""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO / "src"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import harness  # noqa: E402

POBP_FILES = ("test_portbench_faults.py", "test_portbench_lastline.py",
              "test_portbench_obs_readers.py")
POBP_TESTS = ("test_tiny_specs_come_from_the_cells_files",)


def _pobp_only(item) -> bool:
    return (item.path.name in POBP_FILES
            or item.originalname in POBP_TESTS)


def pytest_collection_modifyitems(config, items):
    drop = []
    for item in items:
        params = getattr(getattr(item, "callspec", None), "params", {})
        cell = params.get("cell")
        if cell is None or not _pobp_only(item):
            continue
        if harness.cell_spec(cell)["traffic"]["driver"] != "train":
            drop.append(item)
    if drop:
        config.hook.pytest_deselected(items=drop)
        gone = {id(i) for i in drop}
        items[:] = [i for i in items if id(i) not in gone]
