#!/usr/bin/env python3
"""Run one cell of the benchmark of ``gstpu_torch`` once.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run makes its inputs from the seed on
the card, warms up (set-up), measures for ``--seconds``, then compares what
the timed path produced with the plain reference (``gsbench/reference``).
With ``--trace 1`` it also profiles a short steady sub-window and reports
the cell's per-layer metrics in place of its end-to-end ones.  The last
line of standard output is one JSON object; the numbers compared, each with
its limit, are the last lines of standard error.  Exits non-zero, printing
no result, without a CUDA card, with fewer cards than the cell asks for, or
if JAX or the JAX package got loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "gstpu"}


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def _caches(root: Path) -> None:
    """Triton's kernel cache at a fixed path inside the checkout (the port
    builds its CUDA kernels under build/gstpu_torch itself)."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def execute(args, root: Path = ROOT, device=None, t0: float = T0):
    """One run: the result's dict, its ``checks`` last.  ``root`` holds the
    manifest and the cell's data files; ``device`` None means the CUDA
    card, which must be there (SystemExit without it)."""
    import torch

    for path in (str(ROOT), str(HERE)):
        if path not in sys.path:
            sys.path.insert(0, path)
    from harness import manifest

    bench = manifest.load(root)
    cell = manifest.workload(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: the benchmark runs on the card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{args.workload} needs {cell['chips']} cards, "
                             f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    driver = manifest.driver(bench, args.workload, args.seed, device, t0, root)

    driver.setup()
    measured = driver.window(args.seconds)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if args.trace:
        driver.traced(driver.traffic["traced_items"], f"gsbench_{args.workload}_{args.seed}")
    loaded = forbidden_modules()
    if loaded:
        raise SystemExit("loaded in the run: " + ", ".join(loaded))

    values = dict(measured, setup_s=driver.setup_s, peak_mem_gib=peak / 2**30)
    metrics = {}
    for m in manifest.metrics(bench, args.workload, bool(args.trace)):
        if args.trace:
            value = manifest.reader(m["name"], root)(driver)
        else:       # ``<quantity>.<qualifier>``: the quantity, under a bound of its own
            value = values.get(m["name"], values.get(m["name"].split(".")[0]))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    numbers = driver.compare(*driver.readings())
    print(f"reference: {driver.reference_s:.3f} s", file=sys.stderr)
    limits = manifest.limits(args.workload, root)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": driver.attempted, "failed": driver.failed,
              "metrics": metrics, "device": device_info}
    if args.trace:
        device_info.update(busy_s=driver.trace.busy_s, window_s=driver.trace.window_s)
        result["breakdown"] = {"device_ops": driver.trace.device_ops,
                               "idle_gaps": driver.trace.idle_gaps}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    _caches(ROOT)
    try:
        result = execute(args)
    except SystemExit as e:
        print(f"gsbench: {e}", file=sys.stderr)
        return 2
    loaded = forbidden_modules()
    if loaded:
        print("gsbench: loaded in the run: " + ", ".join(loaded), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
