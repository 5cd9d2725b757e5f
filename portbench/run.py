"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints the check's numbers beside their limits
as the last lines on standard error and, as the last line on standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; ``check`` comes last.  Exits non-zero,
printing no result, without a CUDA device (or fewer than the cell asks for),
when the port cannot be imported, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import core

    try:
        plan = core.plan(args.workload)
    except core.SpecError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < plan.chips:
        print(f"portbench: {args.workload} needs {plan.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 3
    import importlib

    importlib.import_module(core.PORT)  # the system under test: without it there is nothing to run
    result, lines = core.run_cell(plan, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    loaded = core.forbidden_modules()
    if loaded:
        print(f"portbench: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
