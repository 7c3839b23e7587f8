"""``examples/train_e2e_torch.py``, the twin of ``examples/train_e2e.py``,
on the CPU at a few steps: the nll falls over a run from step 0, and a run
cut short at a checkpoint (``--stop-at``) then resumed ends with the same
bits as a straight run; ``launch/train.py``'s ``--stop-at``."""
import importlib.util
import pathlib

import pytest
import torch

from repro_torch.checkpoint.store import latest_step, load_checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def e2e():
    spec = importlib.util.spec_from_file_location(
        "train_e2e_torch", ROOT / "examples" / "train_e2e_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_resumed_run_equals_straight_run(e2e, tmp_path):
    args = ["--device", "cpu", "--steps", "20"]
    straight, cut = tmp_path / "straight", tmp_path / "cut"
    history = e2e.main(args + ["--ckpt-dir", str(straight)])
    assert history[0]["step"] == 1 and history[-1]["step"] == 20
    assert history[-1]["nll"] < history[0]["nll"]
    e2e.main(args + ["--ckpt-dir", str(cut), "--stop-at", "10"])
    assert latest_step(str(cut)) == 10
    resumed = e2e.main(args + ["--ckpt-dir", str(cut)])
    assert resumed[0]["step"] == 11 and resumed[-1]["step"] == 20
    assert latest_step(str(straight)) == latest_step(str(cut)) == 20
    a = load_checkpoint(str(straight), 20)[1]
    b = load_checkpoint(str(cut), 20)[1]
    assert a.keys() == b.keys() and len(a) > 10
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # a resumed run's history starts where it resumed
    assert [h["step"] for h in resumed] == [11, 20]


def test_example_without_device_needs_a_gpu(e2e, tmp_path):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e.main(["--steps", "2", "--ckpt-dir", str(tmp_path)])
