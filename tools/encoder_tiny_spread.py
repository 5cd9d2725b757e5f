#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s tiny encoder check several times on one CUDA GPU,
with cuDNN's default algorithms and then held to its deterministic ones.

    python3 tools/encoder_tiny_spread.py [--reps 6] [--out FILE]

Each run trains the tiny configuration's encoder (400 steps, batch 16, the
same seeds every run), reads its zero-step decode over 256 samples and
solves 3 samples from the encoder's init and from LHS starts
(``chip_smoke.encoder_tiny``).  With the default algorithms the runs of one
seed differ (the weight gradients' summation order); with the deterministic
ones they must not.  One JSON line a run, with the card's name and power
limit, and a summary line a mode: how many runs met phase 9's criterion
(the encoder-init solve no more than one bit in 8 below LHS).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=6, help="runs in each mode")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("encoder_tiny_spread: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    port = chip_smoke.import_port()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    port["_cuda"].build()
    port["_cuda"].library()
    gpu = chip_smoke.gpu_name_and_power()
    sink = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        runs = []
        for rep in range(args.reps):
            rec = chip_smoke.encoder_tiny(torch, port)
            rec.update(rep=rep, gpu=gpu)
            emit(rec)
            runs.append(rec)
        met = [r["bit_acc_encoder_init"] >= r["bit_acc_lhs"] - 1.0 / 8 for r in runs]
        outcomes = {(r["bit_acc_encoder_init"], r["bit_acc_lhs"], r["zero_step_decode_256"]) for r in runs}
        emit({"summary": True, "cudnn_deterministic": deterministic, "runs": len(runs),
              "criterion_met": sum(met), "distinct_outcomes": len(outcomes),
              "bit_acc_encoder_init": [r["bit_acc_encoder_init"] for r in runs],
              "bit_acc_lhs": [r["bit_acc_lhs"] for r in runs],
              "zero_step_decode_256": [r["zero_step_decode_256"] for r in runs], "gpu": gpu})
    torch.backends.cudnn.deterministic = False
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
