"""The plain reference agrees with itself in blocks and whole, follows the
configuration files' statements, and matches the port in float32 at the
port's smoke sizes (the port's plain versions on the CPU)."""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from conftest import SERVE_CELLS, TRAIN_CELLS, smoke_config
from conftest import BENCH

import json


def spec_and_weights(name, seed=3):
    from pbench import program, weights
    from reference import model
    from repro_torch.models import registry as R
    conf = smoke_config(json.loads(
        (BENCH / "configs" / f"{name.split('.')[0]}.json").read_text()))
    cfg = dataclasses.replace(program.arch(conf), dtype="float32")
    tree = R.init_params(cfg, device="meta", param_dtype=torch.float32)
    tmpl = weights.flatten(tree)
    W = weights.make(tmpl, program.sizes(conf), seed, "cpu")
    return conf, cfg, tree, model.Spec(conf), W


def test_attention_in_blocks_is_attention_whole(monkeypatch):
    from reference import model
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 37, 4, 8, generator=g)
    k = torch.randn(2, 37, 2, 8, generator=g)
    v = torch.randn(2, 37, 2, 8, generator=g)
    whole = model.attend(q, k, v, 0, "fp32")
    monkeypatch.setattr(model, "QBLOCK", 5)
    assert torch.allclose(model.attend(q, k, v, 0, "fp32"), whole,
                          atol=1e-6)
    # by hand: head h reads key head h // 2, causal softmax
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(2, dim=2)) / 8 ** 0.5
    s = s.masked_fill(torch.ones(37, 37).triu(1).bool(), float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1),
                     v.repeat_interleave(2, dim=2))
    assert torch.allclose(whole, o, atol=1e-5)


def test_moe_slots_and_capacity_by_hand():
    from reference import model
    conf, cfg, tree, s, W = spec_and_weights(TRAIN_CELLS[1])
    h = torch.randn(50, s.d, generator=torch.Generator().manual_seed(1))
    p = "layers.0.ffn."
    y, aux = model.moe(h, W, p, s, "fp32")
    probs = torch.softmax(h @ W[p + "router"], -1)
    C = s.capacity(50)
    used = [0] * s.E
    want = torch.zeros_like(h)
    for t in range(50):
        w, idx = torch.topk(probs[t], s.k)
        w = w / w.sum()
        for wi, e in zip(w, idx.tolist()):
            if used[e] < C:
                x = h[t]
                want[t] += wi * ((F.silu(x @ W[p + "w1"][e]) *
                                  (x @ W[p + "w3"][e])) @ W[p + "w2"][e])
            used[e] += 1
    assert torch.allclose(y, want, atol=1e-5)
    assert C == max(8, (int(50 * s.k * s.cf / s.E) + 7) // 8 * 8)


def test_chunked_loss_is_the_whole_loss(monkeypatch):
    from reference import model
    conf, cfg, tree, s, W = spec_and_weights(TRAIN_CELLS[0])
    g = torch.Generator().manual_seed(2)
    tok = torch.randint(0, s.V, (2, 40), generator=g)
    lab = torch.randint(0, s.V, (2, 40), generator=g)
    a = model.train_loss(W, s, tok, lab, "fp32")
    monkeypatch.setattr(model, "LOSS_CHUNK", 7)
    assert torch.allclose(model.train_loss(W, s, tok, lab, "fp32"), a,
                          atol=1e-6)


@pytest.mark.parametrize("name", [SERVE_CELLS[1]])
def test_decode_through_the_cache_is_the_full_forward(name):
    from reference import model
    conf, cfg, tree, s, W = spec_and_weights(name)
    g = torch.Generator().manual_seed(4)
    prompts = torch.randint(1, s.V, (3, 20), generator=g)
    fed = torch.randint(1, s.V, (3, 5), generator=g)
    lg = model.prefill_decode_logits(W, s, prompts, fed, "fp32")
    full = torch.cat([prompts, fed], 1)
    pos = [list(range(19, 25))] * 3
    tf = model.teacher_forced_logits(W, s, full, pos, "fp32")
    for b in range(3):
        assert torch.allclose(lg[b], tf[b], atol=1e-4)


def test_fp8_rounds_to_a_sixteenth():
    from reference import model
    x = torch.randn(1000, generator=torch.Generator().manual_seed(5))
    q = model.fp8(x)
    big = x.abs() > x.abs().max() / 64
    rel = ((q - x).abs() / x.abs())[big]
    assert rel.max() <= 2 ** -4 + 1e-6 and rel.mean() > 2 ** -8


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_reference_loss_and_gradient_match_the_port(name):
    from pbench import weights
    from reference import model
    from repro_torch.models import registry as R
    conf, cfg, tree, s, W = spec_and_weights(name)
    g = torch.Generator().manual_seed(6)
    tok = torch.randint(0, s.V, (2, 48), generator=g)
    lab = torch.randint(0, s.V, (2, 48), generator=g)
    params = weights.unflatten_into(tree, {k: v.clone().requires_grad_(True)
                                           for k, v in W.items()})
    dispatch = conf["as_run"]["moe_dispatch"]
    loss, _ = R.forward_train(params, cfg, {"tokens": tok, "labels": lab},
                              moe_dispatch=dispatch, device="cpu")
    loss.backward()
    Wr = {k: v.clone().requires_grad_(True) for k, v in W.items()}
    ref = model.train_loss(Wr, s, tok, lab, "fp32")
    ref.backward()
    assert float(loss.detach()) == pytest.approx(float(ref.detach()), rel=1e-5)
    flat = weights.flatten(params)
    for k in W:
        a, b = flat[k].grad, Wr[k].grad
        assert torch.allclose(a, b, atol=1e-5 * float(b.abs().max()) + 1e-9), k


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_reference_serving_matches_the_port(name):
    """The port's prefill over a left-padded batch and greedy decode steps
    against the reference's step by step from the same tokens."""
    from pbench import weights
    from reference import model
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    conf, cfg, tree, s, W = spec_and_weights(name)
    params = weights.unflatten_into(tree, {k: v.clone() for k, v in W.items()})
    dispatch = conf["as_run"]["moe_dispatch"]
    g = torch.Generator().manual_seed(7)
    B, P, M = 4, 24, 4
    prompts = torch.randint(1, s.V, (B, P), generator=g)
    prompts[0, :9] = 0                     # left padding, as serve pads
    with torch.inference_mode():
        pre = make_prefill_step(cfg, cache_len=P + M + 1,
                                moe_dispatch=dispatch, device="cpu")
        dec = make_serve_step(cfg, moe_dispatch=dispatch, device="cpu")
        logits, cache = pre(params, {"tokens": prompts.numpy()})
        nxt = logits.argmax(-1)[:, None].to(torch.int32)
        got, fed = [logits], []
        for j in range(M):
            fed.append(nxt[:, 0].long())
            nxt, logits, cache = dec(params, nxt, P + j, cache)
            got.append(logits)
    lg = model.prefill_decode_logits(W, s, prompts, torch.stack(fed, 1),
                                     "fp32")
    assert torch.allclose(torch.stack(got, 1), lg, atol=2e-4)


@pytest.mark.parametrize("name", ["minicpm-2b", "granite-moe-3b-a800m"])
def test_files_hold_the_published_model_and_the_port_as_run(name):
    """Each file's model is the published one, nothing is cut, and the
    port's departures are named: the port's config and the reference
    follow the file's model as run."""
    from pbench import program
    from reference import model
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    assert conf["reduced"] == []
    run = program.model_as_run(conf)
    assert {k for k in run if run[k] != conf["model"].get(k)} == \
        set(conf["port_departs"])
    program.arch(conf)
    model.Spec(conf)
    bent = json.loads(json.dumps(conf))
    first = next(iter(bent["port_departs"]))
    bent["port_departs"][first]["as_run"] = conf["model"][first]
    with pytest.raises(ValueError):
        program.arch(bent) if first in program.FIELDS else model.Spec(bent)
