"""Run one cell of the PyTorch port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints one JSON line last on standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks``: each number compared with its limit) and
the numbers compared as the last lines of standard error.  Exits non-zero
without a result when there is no CUDA card, too few of them, or once the
window has closed a module of JAX or of the JAX package is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout (the
    # port's nvcc build already lives under build/repro_torch there)
    cache = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(BENCH)]

    import torch
    from pbench import cells, runner

    # the port's work is on the card; its host thread launches it, and CPU
    # worker threads would only contend with it for the host's cores
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    bench = cells.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips[args.workload]:
        print(f"portbench: {args.workload} needs {chips[args.workload]} "
              f"cards, {torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    cell = cells.load(bench, ROOT, args.workload)
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             T_START, torch.device("cuda"),
                             runner.limits_for(cell.name))
    bad = runner.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    runner.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
