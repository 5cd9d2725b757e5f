"""Key-registry CLI: issue user keys, analyze identification capacity.

The provider issues distance-separated keys (``issue``); ``capacity``
turns a measured per-bit error rate (1 - bit accuracy) into identification
accuracy at a registry size.  A registry written here loads in the reference
package and the other way round.

Run:
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.keys \
        issue --users 1000 --key_len 64 --min_distance 10 --out registry.json
    python -m attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli.keys \
        capacity --users 1000 --key_len 64 --min_distance 10 --p_bit 0.031
"""

from __future__ import annotations

import argparse
import json
import sys

from ..fingerprint.keys import KeyRegistry, simulate_identification


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Key registries: issue keys, identification capacity")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_issue = sub.add_parser("issue", help="issue a distance-separated key registry")
    p_issue.add_argument("--users", type=int, required=True)
    p_issue.add_argument("--key_len", type=int, default=64)
    p_issue.add_argument("--min_distance", type=int, default=1)
    p_issue.add_argument("--issuance", choices=["rejection", "rm"], default="rejection",
                         help="rejection: random coding with pairwise distance checks (O(N^2), "
                         "practical to ~1e5); rm: Reed-Muller RM(2,m) codewords, guaranteed distance "
                         "2^(m-2) (16 at key_len=64), millions of keys; --min_distance is then ignored")
    p_issue.add_argument("--seed", type=int, default=0)
    p_issue.add_argument("--out", type=str, required=True)

    p_cap = sub.add_parser("capacity", help="identification accuracy at a measured per-bit error rate")
    p_cap.add_argument("--users", type=int, required=True)
    p_cap.add_argument("--key_len", type=int, default=64)
    p_cap.add_argument("--min_distance", type=int, default=1)
    p_cap.add_argument("--p_bit", type=float, required=True,
                       help="per-bit error rate = 1 - measured bit accuracy")
    p_cap.add_argument("--trials", type=int, default=2000)
    p_cap.add_argument("--seed", type=int, default=0)

    args = parser.parse_args(argv)
    if args.cmd == "issue":
        if args.issuance == "rm":
            reg = KeyRegistry.issue_rm(args.users, args.key_len, seed=args.seed)
        else:
            reg = KeyRegistry.issue(args.users, args.key_len, args.min_distance, seed=args.seed)
        reg.save(args.out)
        print(json.dumps({"users": len(reg), "key_len": args.key_len, "min_distance": reg.min_distance,
                          "issuance": args.issuance, "out": args.out}))
        return 0

    reg = KeyRegistry.issue(args.users, args.key_len, args.min_distance, seed=args.seed)
    print(json.dumps(simulate_identification(reg, args.p_bit, n_trials=args.trials, seed=args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
