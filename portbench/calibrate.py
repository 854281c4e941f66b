"""Readings that the correctness limits are set from, on the card at a
cell's own size: for each seed, the numbers that the program's run
gives (the lower readings), with ``--control`` also the numbers of the
control, the plain reference in the program's place computed in bfloat16
against the same reference in float32, and with ``--fault`` those of the
program with a fault planted underneath (``faults.py``): the upper
readings.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 2 [--control]

One process for all the seeds, so the kernels build and the card warms
once; one JSON line a seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("unchanged", "half", "token"),
                    help="plant this fault under the timed path "
                         "(portbench/faults.py)")
    args = ap.parse_args(argv)
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from portbench import faults, harness

    if not torch.cuda.is_available():
        print("portbench: no CUDA card here", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    drv = harness.driver(spec["traffic"]["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        rec = drv.run(spec, seed=seed, seconds=args.seconds, trace_on=False,
                      device="cuda:0", t_start=t0,
                      program=faults.train_program(args.fault)
                      if args.fault else None,
                      control=torch.bfloat16 if args.control else None)
        out = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "program": {k: v["value"]
                           for k, v in rec["check"]["compared"].items()},
               "control": rec["check"].get("control"),
               "e2e": rec["end_to_end"], "wall_s": time.time() - t0}
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
