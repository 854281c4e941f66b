"""Readings that the LM cells' correctness limits are set from, on the card
at a cell's own size: for each seed, the numbers that the program's run
gives (the lower readings), with ``--control`` also those of the control
(the plain reference at that precision in the program's place, against
the same reference in float32), and with ``--fault`` those of the program
with a fault planted underneath (``lm_faults.py``): the upper readings.

    python3 portbench/lm_calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 2 [--control float8] [--fault yarn [--from-step 3]]

One process for all the seeds; one JSON line a seed.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    for p in (str(REPO / "src"), str(REPO)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import harness, lm_faults

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", choices=("bfloat16", "float8"))
    ap.add_argument("--fault", choices=lm_faults.FAULTS,
                    help="plant this fault under the timed path")
    ap.add_argument("--from-step", type=int, default=0,
                    help="the fault's first step (3: the window's steps "
                         "alone, the set-up steps sound)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card here", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    drv = harness.driver(spec["traffic"]["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        rec = drv.run(spec, seed=seed, seconds=args.seconds, trace_on=False,
                      device="cuda:0", t_start=t0,
                      program=lm_faults.train_program(args.fault,
                                                      args.from_step)
                      if args.fault else None, control=args.control)
        out = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "from_step": args.from_step,
               "program": {k: v["value"]
                           for k, v in rec["check"]["compared"].items()},
               "correct": rec["check"]["correct"],
               "control": rec["check"].get("control"),
               "e2e": rec["end_to_end"], "wall_s": time.time() - t0}
        print(json.dumps(out), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
