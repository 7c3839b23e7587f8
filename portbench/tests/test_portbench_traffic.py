"""The mixes' generators repeat for a seed and change with it."""
import numpy as np
import pytest
import torch

from conftest import SERVE_CELLS, TRAIN_CELLS

SEEDS = [0, 7, 2**31 + 11, 2**63 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_repeat_per_seed(smoke_cell, seed):
    from pbench.train import TrainRun
    cell, _ = smoke_cell(TRAIN_CELLS[0])
    a = TrainRun(cell, seed, torch.device("cpu"))
    b = TrainRun(cell, seed, torch.device("cpu"))
    for step in (0, 1, 5):
        x, y = a.batch(step), b.batch(step)
        assert np.array_equal(x["tokens"], y["tokens"])
        assert np.array_equal(x["labels"][:, :-1], x["tokens"][:, 1:])
    assert not np.array_equal(a.batch(0)["tokens"], a.batch(1)["tokens"])
    rows = a.batch(0)["tokens"]
    assert len({r.tobytes() for r in rows}) == len(rows)
    other = TrainRun(cell, seed + 1, torch.device("cpu"))
    assert not np.array_equal(a.batch(0)["tokens"], other.batch(0)["tokens"])


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_rounds_repeat_per_seed(smoke_cell, seed):
    from pbench.serve import ServeRun
    cell, _ = smoke_cell(SERVE_CELLS[0])
    a = ServeRun(cell, seed, torch.device("cpu"))
    b = ServeRun(cell, seed, torch.device("cpu"))
    for r in (0, 3):
        ra, rb = a.round(r), b.round(r)
        assert [m for _, m in ra] == [m for _, m in rb]
        assert all(np.array_equal(p, q) for (p, _), (q, _) in zip(ra, rb))
    c = ServeRun(cell, seed + 1, torch.device("cpu"))
    assert [len(p) for p, _ in a.round(0)] != [len(p) for p, _ in c.round(0)]


def test_serve_rounds_are_stratified():
    """At the committed mix: every round's prompt lengths fall one in each
    sixteenth of the clipped lognormal, and its budgets cover 4-16."""
    import statistics
    from pbench import cells
    from pbench.serve import ServeRun
    from conftest import ROOT
    bench = cells.load_json(ROOT / "BENCHMARK.json")
    cell = cells.load(bench, ROOT, SERVE_CELLS[0])
    run = ServeRun(cell, 12345, torch.device("cpu"))
    pr = cell.traffic["prompt"]
    nd = statistics.NormalDist()
    n = cell.traffic["clients"]
    edges = [pr["median"] * np.exp(pr["sigma"] * nd.inv_cdf(i / n))
             if 0 < i < n else (0 if i == 0 else np.inf) for i in range(n + 1)]
    for r in range(20):
        reqs = run.round(r)
        assert len(reqs) == n
        lens = sorted(len(p) for p, _ in reqs)
        for i, L in enumerate(lens):
            assert pr["min"] <= L <= pr["max"]
            assert min(edges[i], pr["max"]) - 1 <= L <= \
                min(edges[i + 1], pr["max"]) + 1
        news = sorted(m for _, m in reqs)
        assert news[0] >= 4 and news[-1] <= 16
        assert news[0] <= 5 and news[-1] >= 15
        assert all(p.min() >= 1 and p.max() < 49155 for p, _ in reqs)
