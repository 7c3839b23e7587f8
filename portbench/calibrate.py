"""Readings that the limits of ``portbench/limits/<cell>.json`` are set
from, at the cell's own size, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--seconds 6] [--out <directory>]

For each seed, the program's set-up and a short window at the cell's own
load, then the numbers compared against the float32 reference (the lower
readings).  For each control seed, also the reference computed with
float8 products in the program's place (the control), and for a training
cell the reference with half of each step's batch left out (a planted
fault), each against the float32 reference (the upper readings).  One
JSON line a seed on standard output and in
``<directory>/calibrate_<cell>.jsonl`` (by default ``build/portbench``
in the checkout).  The benchmark's own runs never
run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "portbench"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]
    import torch
    from pbench import cells
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = cells.load_json(ROOT / "BENCHMARK.json")
    cell = cells.load(bench, ROOT, args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    with open(out_dir / f"calibrate_{cell.name}.jsonl", "a") as log:
        for seed in sorted(set(seeds) | controls):
            line = readings(cell, seed, args.seconds, dev,
                            seed in controls, seed in seeds)
            print(json.dumps(line), flush=True)
            log.write(json.dumps(line) + "\n")
            log.flush()
    return 0


def readings(cell, seed, seconds, dev, control, program) -> dict:
    """One seed's line: the program's set-up and window, then its driver's
    ``calibration`` readings."""
    import torch
    run = cell.driver(cell, seed, dev)
    t0 = time.perf_counter()
    run.setup()
    run.window(seconds)
    t1 = time.perf_counter()
    run.release()
    line = {"cell": cell.name, "seed": seed,
            "card": torch.cuda.get_device_name(0), "program_s": t1 - t0}
    line.update(run.calibration(control, program))
    line["total_s"] = time.perf_counter() - t0
    return line


if __name__ == "__main__":
    sys.exit(main())
