"""The readings a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload sd15-exact-cb-32f \\
        --seeds 11,12,13 [--control] [--out chiprun_out/cal.jsonl]

For each seed, one run of the cell as ``run.py`` makes it (set-up, one
whole edit through the timed path, the reference check), with the
comparison's numbers printed (one JSON line a seed) instead of judged.
``--control`` puts the control in the program's place (the program's own
int8 path for the UNet, the reference one step lower where the program has
no lower path: ``harness/check.py``), which the limits must fail.  The
benchmark's own runs never run it.  All seeds run in one process, so the
kernels build once.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _, model, traffic, limits, _ = run.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    unlimited = {k: {"limit": float("inf")} for k in limits}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res, readings = run.run_cell(
            model, traffic, unlimited, [], seed, 0.0, False, "cuda",
            torch.cuda.synchronize, control=args.control,
            log=lambda m: print(m, file=sys.stderr))
        line = {"workload": args.workload, "seed": seed,
                "control": args.control,
                "edit_s": traffic["frames"] / res["metrics"][
                    "frames_per_s"]["value"],
                "seconds": time.perf_counter() - t,
                **readings}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
