"""On the card only (``-m gpu``): the traced window sees device time, a cell
runs end to end through ``run.py``, and at each cell's own size a sound
run of the program keeps within the committed limits while the control
(the reference with float8 products in the program's place) and the
planted training faults do not."""
import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, SERVE_CELLS, TRAIN_CELLS

SEED = 2**31 + 977


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_traced_window_sees_the_card():
    need_card()
    from pbench import trace
    x = torch.randn(4096, 4096, device="cuda")
    with trace.Window() as w:
        for _ in range(8):
            x = torch.tanh(x @ x)
    tr = w.trace
    assert 0 < tr.busy_s <= tr.window_s
    assert sum(n for _, n in tr.kernels.values()) >= 16
    assert tr.top_ops()


@pytest.mark.gpu
def test_a_cell_runs_through_run_py():
    need_card()
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "granite-moe-3b-a800m.serve-docs", "--seed", str(2**31 + 3),
         "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


# what has to fail the committed limits in each cell: the control, and in
# training the half batch and the unchanged state
MUST_FAIL = {
    "minicpm-2b.train-4k": ["fp8", "half_batch", "unchanged_state"],
    "granite-moe-3b-a800m.train-4k": ["fp8", "half_batch",
                                      "unchanged_state"],
    "granite-moe-3b-a800m.serve-docs": ["fp8"],
    "minicpm-2b.serve-docs": ["fp8"],
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", TRAIN_CELLS + SERVE_CELLS)
def test_program_within_and_control_beyond_the_limits(name):
    need_card()
    import calibrate
    from pbench import cells, judge, runner
    cell = cells.load(cells.load_json(ROOT / "BENCHMARK.json"), ROOT, name)
    limits = runner.limits_for(name)
    line = calibrate.readings(cell, SEED, 6.0, torch.device("cuda"),
                              True, True)

    def passes(readings):
        r = dict(readings, failed=0, off_route_launches=0)
        return judge.passed(judge.check(r, limits))
    assert passes(line["program"]), line
    for what in MUST_FAIL[name]:
        assert not passes(line[what]), (what, line)
