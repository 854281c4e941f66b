"""The harness: finds a cell's files by name, runs its driver, reads its
metrics and prints the result line.

Layout (every piece found by its name, so a later change adds a cell, a
mix or a metric by adding files and entries, never by editing one):

  BENCHMARK.json                    cells, metrics, run length
  portbench/configs/<config>.json   a configuration: the model and the
                                    algorithm's settings, as run
  portbench/traffic/<mix>.json      a traffic mix: parameters that one
                                    general driver reads (its ``driver``)
  portbench/workloads/<cell>.json   a cell's system settings and the limits
                                    of its correctness check
  portbench/metrics/<metric>.py     a per-layer metric's reader,
                                    ``read(rec) -> float | None``

A driver (``portbench/drivers/<driver>.py``) runs one cell and returns a
record: the window's end-to-end numbers, the counters and spans that the
metric readers take, the device block and the check's numbers.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Dict, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names that no benchmark process may load: the JAX stack
# and the JAX package (``repro_torch`` is the port, whose name begins with
# ``repro``: names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: Path = REPO) -> dict:
    return load_json(repo / "BENCHMARK.json")


def cell_spec(name: str, bench: Optional[dict] = None,
              root: Path = ROOT) -> Dict[str, Any]:
    """Everything a run of cell ``name`` needs: its entry in
    BENCHMARK.json, its configuration, traffic and workload files, and the
    metrics it reports (end to end with ``--trace 0``, per layer with
    ``--trace 1``).  Raises ``KeyError`` for an unknown cell and
    ``ValueError`` when the workload file disagrees with the entry."""
    bench = benchmark() if bench is None else bench
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = load_json(root / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if work[key] != entry[key]:
            raise ValueError(f"{name}: workload file says {key}="
                             f"{work[key]!r}, BENCHMARK.json {entry[key]!r}")

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return dict(
        name=name, chips=int(entry["chips"]),
        config=load_json(root / "configs" / f"{entry['config']}.json"),
        traffic=load_json(root / "traffic" / f"{entry['traffic']}.json"),
        params=work.get("params", {}), limits=work["limits"],
        end_to_end=reported(bench["end_to_end"]),
        per_layer=reported(bench["per_layer"]))


def driver(name: str):
    """The driver module ``portbench/drivers/<name>.py``."""
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of ``portbench/metrics/<name>.py`` (a file named after the
    metric, dots and all, so it is loaded by path)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of `FORBIDDEN`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def per_layer_values(spec: dict, rec: dict, root: Path = ROOT) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    to read for; a reader that returns None leaves its metric out."""
    out = {}
    for m in spec["per_layer"]:
        v = metric_reader(m["name"], root)(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(spec: dict, rec: dict, trace: bool,
                root: Path = ROOT) -> dict:
    """The last line's object: ``correct``, ``attempted``, ``failed``,
    ``metrics`` (the end-to-end metrics, or with ``trace`` the per-layer
    ones), ``device``, with ``trace`` the ``breakdown``, and last the
    numbers compared beside their limits."""
    if trace:
        metrics = per_layer_values(spec, rec, root)
    else:
        metrics = {m["name"]: {"value": float(rec["end_to_end"][m["name"]]),
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    line = {"correct": bool(rec["check"]["correct"]),
            "attempted": int(rec["attempted"]),
            "failed": int(rec["failed"]),
            "metrics": metrics, "device": dict(rec["device"])}
    if trace and rec.get("breakdown") is not None:
        line["breakdown"] = rec["breakdown"]
    line["compared"] = rec["check"]["compared"]
    return line
