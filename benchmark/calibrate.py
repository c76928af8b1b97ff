"""The readings that a cell's limits of ``correct`` are set from (not run by
the benchmark's own runs):

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,... \\
        --control 3 --seconds 4 --out readings.json

In one process (one set-up), for each seed: a short window of the cell's
own jobs at its own size, its images sampled and checked as a run checks
them, giving the program's readings (the lower ones). For the first
``--control`` seeds the control runs too: the reference computed in
bfloat16 (the precision below the configuration's float32) put in the
program's place, read against the float32 reference at the same pixels
(the upper ones). Writes every reading to ``--out`` and prints a summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import check  # noqa: E402
import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", type=int, default=3, help="seeds (the first ones) that run the control")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    bench = harness.Bench(args.workload, seeds[0], device=args.device)
    import torch

    out = {"workload": args.workload, "device": torch.cuda.get_device_name(bench.dev) if bench.cuda else "cpu",
           "card": harness.card_line() if bench.cuda else "none", "seeds": {}}
    for k, seed in enumerate(seeds):
        win = bench.window(seed, args.seconds, False)
        dtypes = [torch.bfloat16] if k < args.control else []
        rows = bench.check(seed, win["kept"], dtypes)
        rec = {"images": len(win["jobs"]), "failed": win["failed"],
               "program": check.readings(np.concatenate([check.gaps(r[0], r[1]) for r in rows]))}
        if dtypes:
            rec["control"] = check.readings(np.concatenate([check.gaps(r[2], r[1]) for r in rows]))
        out["seeds"][str(seed)] = rec
        print(seed, json.dumps(rec), file=sys.stderr, flush=True)
    prog = [r["program"] for r in out["seeds"].values()]
    ctrl = [r["control"] for r in out["seeds"].values() if "control" in r]
    out["lower"] = {k: max(r[k] for r in prog) for k in check.COMPARED}
    out["upper"] = {k: min(r[k] for r in ctrl) for k in check.COMPARED} if ctrl else None
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"workload": args.workload, "lower": out["lower"], "upper": out["upper"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
