"""A run with the timed path broken underneath comes out not correct, at
the port's smoke sizes on the CPU with the committed limits: the
harness's look for a card is skipped, the rest of a run is driven as on
the card.  A sound run at these sizes is not held to the limits (they
are set from full-size runs on the card, where a smoke model's round-off
differs); ``test_portbench_gpu`` holds sound runs and the control to them
at the cells' own sizes."""
import time

import pytest
import torch

from conftest import SERVE_CELLS, TRAIN_CELLS

SEED = 2**31 + 101


def run(cell, limits, seconds=1.0):
    from pbench import runner
    return runner.run_cell(cell, SEED, seconds, False, time.perf_counter(),
                           torch.device("cpu"), limits)


def failing(result):
    return sorted(n for n, c in result["checks"].items()
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("name", TRAIN_CELLS + SERVE_CELLS)
def test_a_run_compares_every_limit(smoke_cell, name):
    cell, limits = smoke_cell(name)
    res = run(cell, limits)
    assert list(res["checks"]) == list(limits)
    assert list(res)[-1] == "checks"
    assert res["failed"] == 0 and res["attempted"] > 0
    assert all(c["value"] == c["value"] for c in res["checks"].values())


def compared_gaps(limits):
    return sorted(k for k in limits if k.startswith("gap_"))


def _wrap_train_step(monkeypatch, make):
    from repro_torch.launch import steps
    orig = steps.make_train_step
    monkeypatch.setattr(steps, "make_train_step",
                        lambda *a, **k: make(orig, *a, **k))


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_state_unchanged(smoke_cell, monkeypatch, name):
    def make(orig, cfg, ocfg, **kw):
        inner = orig(cfg, ocfg, **kw)

        def step(params, opt, batch):
            import copy
            _, _, metrics = inner(copy.deepcopy(params),
                                  copy.deepcopy(opt), batch)
            return params, opt, metrics
        return step
    _wrap_train_step(monkeypatch, make)
    cell, limits = smoke_cell(name)
    res = run(cell, limits)
    assert not res["correct"]
    assert "change_norm_rel" in failing(res)


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_half_batch(smoke_cell, monkeypatch, name):
    def make(orig, cfg, ocfg, accum_steps=1, **kw):
        inner = orig(cfg, ocfg, accum_steps=1, **kw)

        def step(params, opt, batch):
            half = {k: v[:len(v) // 2] for k, v in batch.items()}
            return inner(params, opt, half)
        return step
    _wrap_train_step(monkeypatch, make)
    cell, limits = smoke_cell(name)
    res = run(cell, limits)
    assert not res["correct"], res["checks"]
    assert failing(res) and "failed" not in failing(res)


def _wrap_serve(monkeypatch, after):
    from repro_torch.launch import serve as S
    orig = S.serve

    def serve(cfg, requests, **kw):
        return after(orig(cfg, requests, **kw), cfg)
    monkeypatch.setattr(S, "serve", serve)


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_serve_token_altered(smoke_cell, monkeypatch, name):
    def after(done, cfg):
        for r in done:
            r.generated[-1] = (r.generated[-1] + 1) % cfg.vocab_size
        return done
    _wrap_serve(monkeypatch, after)
    cell, limits = smoke_cell(name)
    res = run(cell, limits)
    assert failing(res) == compared_gaps(limits), res["checks"]


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_serve_half_the_batch_left_out(smoke_cell, monkeypatch, name):
    _wrap_serve(monkeypatch, lambda done, cfg: done[:len(done) // 2])
    cell, limits = smoke_cell(name)
    res = run(cell, limits)
    assert "failed" in failing(res)


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_serve_cache_unchanged(smoke_cell, monkeypatch, name):
    """Decode steps that leave the cache as they found it: the state
    unchanged."""
    from repro_torch.models import registry as R
    orig = R.decode_step

    def decode_step(params, cfg, tokens, pos, cache, **kw):
        keep = [{k: t.clone() for k, t in layer.items()}
                for layer in cache["layers"]]
        logits, new = orig(params, cfg, tokens, pos, cache, **kw)
        for layer, old in zip(new["layers"], keep):
            for k, t in layer.items():
                t.copy_(old[k])
        return logits, new
    monkeypatch.setattr(R, "decode_step", decode_step)
    cell, limits = smoke_cell(name)
    # short prompts, so that the keys the decode steps fail to keep are
    # most of what each step attends (over prompts of thousands of
    # tokens, random weights spread the attention too thinly for them to
    # move a served token)
    cell.traffic["prompt"].update(median=6, min=2, max=10)
    res = run(cell, limits)
    assert failing(res) == compared_gaps(limits), res["checks"]
