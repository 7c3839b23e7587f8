#!/usr/bin/env python3
"""Time chip_smoke.py's recurrentgemma-9b train step in several checkouts,
in turns, on one GPU.

    python3 tools/train_step_ab.py [--steps N] CHECKOUT [CHECKOUT ...]

Each CHECKOUT is the root of a checkout of the repository (for instance a
``git archive`` of the parent commit unpacked under ``build/``).  Each runs
in a process of its own, in the order given (give parent, change, change,
parent to compare two commits): its own ``chip_smoke.phase_train`` for
recurrentgemma-9b at full width and chip_smoke's cut depth, 2 x 4096 as two
microbatches, for N AdamW steps (default 10) and an eval, with every
launch check of that phase live and no profile.  It prints each run's step
times after the first (which builds the kernels), their median, and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ast
import os
import statistics
import subprocess
import sys

# run inside a checkout: its chip_smoke.py, with the step count set
CHILD = """
import chip_smoke as C
C.TRAIN_STEPS = {steps}
_, _, r = C.phase_train(C.GRIFFIN_ARCH, C.GRIFFIN_TRAIN_LAYERS, profile=False)
print("STEPS_MS", [h["ms"] for h in r["steps"]], flush=True)
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("checkouts", nargs="+")
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    failed = False
    for root in args.checkouts:
        proc = subprocess.run([sys.executable, "-c",
                               CHILD.format(steps=args.steps)],
                              cwd=os.path.abspath(root), capture_output=True,
                              text=True)
        found = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("STEPS_MS ")]
        if proc.returncode or not found:
            print(f"{root}: exit {proc.returncode}\n{proc.stdout[-4000:]}"
                  f"\n{proc.stderr[-4000:]}", flush=True)
            failed = True
            continue
        steady = ast.literal_eval(found[0].split(" ", 1)[1])[1:]
        print(f"{root}: steps 2-{args.steps} "
              + " ".join(f"{ms:.1f}" for ms in steady)
              + f" ms; median {statistics.median(steady):.2f} ms, "
              f"{min(steady):.1f}-{max(steady):.1f}", flush=True)
    print(card, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
