"""The control (and the faults) of a cell, on the card, at the cell's size.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --seconds <s> [--fault understate]

Runs the cell once a seed, in one process, with ``faults.<fault>`` applied
to the timed path after set-up (default ``understate``, the control: a
liability one lower than the snapshot holds), and prints one JSON line a
seed: the numbers compared and their limits, and whether the run came out
correct. The benchmark's own runs (``run.py``) never apply a fault.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import faults, run, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default="understate", choices=sorted(faults.FAULTS))
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    run.set_caches(cell.root)
    for seed in (int(s) for s in args.seeds.split(",")):
        result = run.execute(cell, seed, args.seconds, False, "cuda:0", fault=args.fault)
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "failed": result["failed"], "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
