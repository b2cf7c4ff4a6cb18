#!/usr/bin/env python3
"""The readings that a cell's limits are set from (not run by the
benchmark's own runs).

    python3 gsbench/calibrate.py --workload <cell> --seeds 101-112 \\
        --control-seeds 101-103 [--seconds 3]

For every seed, a run as the benchmark makes it (set-up, a short window at
the cell's own load, the program's readings against the reference's) and
the numbers it compares.  For every control seed, also the control's: the
reference put in the program's place and computed with TF32 on, the
nearest precision below the configuration's float32 with TF32 off; and
each fault that the cell's driver names, planted in the reference put in
the program's place.  One JSON line per seed and kind.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    import torch

    from harness import manifest

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = manifest.load()
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        driver = manifest.driver(bench, args.workload, seed, device, time.perf_counter())
        driver.setup()
        driver.window(args.seconds)
        got, want = driver.readings()
        lines = []
        if seed in args.seeds:
            lines.append(("program", driver.compare(got, want)))
        if seed in args.control_seeds:
            lines.append(("control_tf32", driver.compare(
                driver.reference_readings(got, tf32=True), want)))
            for name, fault in driver.faults.items():
                with fault():
                    lines.append((f"fault_{name}", driver.compare(
                        driver.reference_readings(got), want)))
        for kind, numbers in lines:
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "numbers": numbers, "setup_s": driver.setup_s,
                              "reference_s": driver.reference_s}), flush=True)
        del driver, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
