"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  One process a run: the inputs are made on
the device from ``--seed``, only the cell's shapes are warmed, the window
lasts ``--seconds``, and the last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` the ``breakdown``, and last ``compared``: each number
of the correctness check beside its limit, also the last lines on
standard error).  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window.

Exits non-zero, printing no result, when no card (or fewer than the cell
asks for) is there, and when a module of the JAX stack or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()      # the set-up's clock starts with the process

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def bytecode_cache() -> None:
    """Compile the Python modules a run imports (torch's thousands among
    them) once per checkout, into ``.pbcache/pycache`` inside it, and load
    them from there in later runs, also where the environment turns the
    writing of bytecode off (``PYTHONDONTWRITEBYTECODE``) or the installed
    packages carry none: compiling them anew took 6-9 s of every run's
    set-up on the card's host."""
    sys.pycache_prefix = str(REPO / ".pbcache" / "pycache")
    sys.dont_write_bytecode = False


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bytecode_cache()
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import harness

    spec = harness.cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card here; the benchmark measures the "
              "card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"portbench: {args.workload} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    drv = harness.driver(spec["traffic"]["driver"])
    rec = drv.run(spec, seed=args.seed, seconds=args.seconds,
                  trace_on=bool(args.trace), device="cuda:0",
                  t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of the JAX stack or package loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    rec["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": spec["chips"],
                     "memory_peak_bytes": int(rec["peak_bytes"])}
    if args.trace and rec.get("trace"):
        rec["device"]["busy_s"] = rec["trace"]["busy_s"]
        rec["device"]["window_s"] = rec["trace"]["window_s"]
    line = harness.result_line(spec, rec, bool(args.trace))
    print(f"portbench: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr)
    for note in rec["notes"]:
        print(f"portbench: {note}", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
