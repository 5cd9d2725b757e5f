"""Readings behind a cell's limits, on the card: the numbers compared for the
port on many seeds, and for the control (the reference one precision below
the cell's dtype, in the port's place) on some of them, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 --seconds <s> [--out FILE]

Each seed is a whole run of the cell (set-up, a window of ``--seconds``, the
comparison); the control reads the same window's states.  One JSON line a
seed; with ``--out`` the lines are appended to that file too.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from portbench import core

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    plan = core.plan(args.workload)
    control = core.CONTROL[plan.traffic.get("dtype", "float32")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, _ = core.run_cell(plan, seed, args.seconds, False, torch.device("cuda", 0), t0,
                                  (control,) if seed in controls else ())
        line = json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                           "attempted": result["attempted"], "failed": result["failed"],
                           "check": {k: v["value"] for k, v in result["check"].items()},
                           "controls": result.get("controls", {}), "metrics": result["metrics"],
                           "seconds": time.perf_counter() - t0, "card": result["card"]})
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
