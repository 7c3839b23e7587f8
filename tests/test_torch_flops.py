"""The port's step count (``distributed.flops.FlopCounter``) on the CPU:
matrix products at 2 m n k, a Python loop counted as one iteration times
its trip count equal to the loop unrolled, a reduced config's step with
the same totals on ``meta`` and on the CPU for every block kind (train,
prefill and decode), each kernel call counted by its ``cost.work`` on both
devices, and the kernel wrappers on ``meta`` (empty outputs of the right
shapes) and on the CPU (the plain version, unchanged, with or without a
counter)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data import batch_for
from repro_torch.distributed import flops
from repro_torch.distributed.flops import FlopCounter
from repro_torch.kernels.flash_attention import cost as fa_cost
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.mlstm_scan import cost as ml_cost
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.mlstm_scan import ref as ml_ref
from repro_torch.kernels.moe_gmm import cost as gmm_cost
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as gmm_ref
from repro_torch.kernels.rglru_scan import cost as rg_cost
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import ref as rg_ref
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models import registry as R
from repro_torch.models import xlstm
from repro_torch.models.config import ShapeSpec
from repro_torch.models.transformer import softmax_xent_from_hidden
from repro_torch.optim import AdamWConfig, adamw_init


def _randn(*shape, dtype=torch.float32, device="cpu", grad=False, seed=0):
    g = np.random.default_rng(seed)
    t = torch.as_tensor(g.standard_normal(shape), dtype=torch.float32)
    return t.to(dtype).to(device).requires_grad_(grad)


def test_matmul_chain_counts_2mnk_each():
    m, k, n, p = 8, 16, 32, 4
    for device in ("cpu", "meta"):
        a, b, c = (_randn(*s, device=device) for s in
                   ((m, k), (k, n), (n, p)))
        with FlopCounter() as fc:
            (a @ b) @ c
        assert fc.totals.flops == 2 * m * k * n + 2 * m * n * p
        # a @ b reads a and b and writes (m, n); then reads it and c
        assert fc.totals.traffic_bytes == 4 * (m * k + k * n + m * n
                                               + m * n + n * p + m * p)


def test_views_and_factories_move_no_bytes():
    x = torch.empty(4, 8, device="meta")
    with FlopCounter() as fc:
        x.view(8, 4)[1:].unsqueeze(0).transpose(1, 2)
        torch.empty(16, 16, device="meta")
        torch.zeros(4, 4, device="meta")           # writes, reads nothing
    assert fc.totals.flops == 0 and fc.totals.traffic_bytes == 4 * 16


def _recurrence(w, x, n):
    h, outs = x, []
    for _ in flops.loop(n):
        h = torch.tanh(h @ w) + x
        outs.append(h.sum())
    return h.sum() + outs[0]


def _unrolled(monkeypatch):
    """Every iteration of ``flops.loop`` runs and counts."""
    monkeypatch.setattr(flops, "loop", range)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("backward", [False, True])
def test_scaled_loop_equals_unrolled(device, backward, monkeypatch):
    n = 7
    totals = []
    for scale in (True, False):
        if not scale:
            _unrolled(monkeypatch)
        w = _randn(16, 16, device=device, grad=True)
        x = _randn(4, 16, device=device, seed=1)
        with FlopCounter() as fc:
            with torch.set_grad_enabled(backward):
                y = _recurrence(w, x, n)
                if backward:
                    y.backward()
        totals.append(fc.totals)
    scaled, unrolled = totals
    # each step's product, and in the backward its gradient to w and (but
    # for the first step's, whose x needs none) to h
    assert unrolled.flops == (2 * 4 * 16 * 16) * (
        3 * n - 1 if backward else n)
    assert scaled.flops == unrolled.flops
    assert scaled.traffic_bytes == unrolled.traffic_bytes


def test_loop_runs_three_iterations_under_a_counter():
    seen = []
    for i in flops.loop(5):
        seen.append(i)
    with FlopCounter():
        for i in flops.loop(5):
            seen.append(i)
    with FlopCounter():
        for i in flops.loop(3):
            seen.append(i)
    assert seen == [0, 1, 2, 3, 4, 0, 1, 4, 0, 1, 2]


@pytest.mark.parametrize("what", ["slstm", "chunked loss"])
def test_model_loops_scaled_equal_unrolled(what, monkeypatch):
    """The sLSTM's steps over time and the loss's chunks, forward and
    backward, at a small S: the scaled count equals every iteration
    counted."""
    cfg = get_arch("xlstm-1.3b").reduced()
    totals = []
    for scale in (True, False):
        if not scale:
            _unrolled(monkeypatch)
        with FlopCounter() as fc:
            if what == "slstm":
                p = R.init_params(cfg, 0, device="cpu")["layers"][1]["mix"]
                x = _randn(2, 9, cfg.d_model, grad=True)
                xlstm.apply_slstm(x, p, cfg).float().sum().backward()
            else:
                x = _randn(2, 40, 16, grad=True)
                head = _randn(16, 50, seed=2, grad=True)
                labels = torch.randint(0, 50, (2, 40),
                                       generator=torch.Generator()
                                       .manual_seed(0))
                loss, _ = softmax_xent_from_hidden(x, head, labels, chunk=8)
                loss.backward()
        totals.append(fc.totals)
    assert totals[0].flops == totals[1].flops > 0
    assert totals[0].traffic_bytes == totals[1].traffic_bytes


# a reduced config of each block kind; remat "full" as the configs train
KINDS = [("minicpm-2b", "einsum"), ("granite-moe-3b-a800m", "gather"),
         ("recurrentgemma-9b", "einsum"), ("xlstm-1.3b", "einsum"),
         ("llama-3.2-vision-11b", "einsum"), ("hubert-xlarge", "einsum")]


def _count_step(arch, dispatch, kind, device):
    cfg = dataclasses.replace(get_arch(arch).reduced(), remat="full")
    S = 24
    if kind == "train":
        params = R.init_params(cfg, 0, device=device,
                               param_dtype=torch.float32)
        opt = adamw_init(params)
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch_for(
            cfg, ShapeSpec("t", S, 4, "train"), seed=0).items()}
        step = make_train_step(cfg, AdamWConfig(), moe_dispatch=dispatch,
                               accum_steps=2, device=device)
        with FlopCounter() as fc:
            step(params, opt, batch)
        return fc.totals
    params = R.init_params(cfg, 0, device=device)
    if kind == "prefill":
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch_for(
            cfg, ShapeSpec("t", S, 2, "prefill"), seed=0).items()
            if k != "labels" and k != "mask"}
        step = make_prefill_step(cfg, moe_dispatch=dispatch, device=device)
        with FlopCounter() as fc, torch.no_grad():
            step(params, batch)
        return fc.totals
    cache = R.init_cache(cfg, 2, S, device=device)
    tokens = torch.zeros((2, 1), dtype=torch.int32, device=device)
    step = make_serve_step(cfg, moe_dispatch=dispatch, device=device)
    with FlopCounter() as fc, torch.inference_mode():
        step(params, tokens, S - 1, cache)
    return fc.totals


# every kind with every block kind; the encoder-only audio model has no
# decode step
STEPS = [(a, d, k) for a, d in KINDS for k in ("train", "prefill", "decode")
         if not (a == "hubert-xlarge" and k == "decode")]


@pytest.mark.parametrize("arch,dispatch,kind", STEPS,
                         ids=[f"{a}-{k}" for a, _, k in STEPS])
def test_step_counts_the_same_on_meta_and_cpu(arch, dispatch, kind):
    cpu = _count_step(arch, dispatch, kind, "cpu")
    meta = _count_step(arch, dispatch, kind, "meta")
    assert cpu.flops > 0 and cpu.traffic_bytes > 0
    assert cpu.flops == meta.flops
    assert cpu.traffic_bytes == meta.traffic_bytes
    assert cpu.kernels == meta.kernels
    assert cpu.total_wire_bytes == meta.total_wire_bytes == 0


def _kernel_calls(fn, inputs):
    """Run ``fn`` on ``inputs`` under a counter, forward and backward."""
    with FlopCounter() as fc:
        outs = fn(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        torch.autograd.backward([o.float().sum() for o in outs[:1]])
    return fc.totals


def _kernel_cases(device):
    q = _randn(2, 20, 4, 16, device=device, grad=True)
    k = _randn(2, 20, 2, 16, device=device, seed=1, grad=True)
    v = _randn(2, 20, 2, 16, device=device, seed=2, grad=True)
    xe = _randn(3, 8, 16, device=device, grad=True)
    w = {n: _randn(*s, device=device, seed=i, grad=True) for i, (n, s) in
         enumerate((("w1", (3, 16, 24)), ("w3", (3, 16, 24)),
                    ("w2", (3, 24, 16))))}
    counts = torch.tensor([8, 3, 0], dtype=torch.int32, device=device)
    x, ga, gx = (_randn(2, 10, 32, device=device, seed=s, grad=True)
                 for s in range(3))
    lam = _randn(32, device=device, seed=4, grad=True)
    b = [_randn(32, device=device, seed=s, grad=True) for s in (5, 6)]
    mq, mk, mv = (_randn(2, 12, 2, 8, device=device, seed=s, grad=True)
                  for s in range(3))
    ig, fg = (_randn(2, 12, 2, device=device, seed=s, grad=True)
              for s in (3, 4))
    return [
        ("flash_attention", lambda q, k, v: fa_ops.flash_attention(
            q, k, v, causal=True, window=6), (q, k, v),
         fa_cost.work(2, 20, 4, 2, 16, True, 6, torch.float32),
         fa_cost.bwd_work(2, 20, 4, 2, 16, True, 6, torch.float32)),
        ("moe_gmm", lambda xe, w1, w3, w2: gmm_ops.expert_ffn(
            xe, {"w1": w1, "w3": w3, "w2": w2}, "swiglu", counts),
         (xe, w["w1"], w["w3"], w["w2"]),
         gmm_cost.work(3, 8, 16, 24, True, torch.float32),
         gmm_cost.bwd_work(24, 3, 16, 24, True, torch.float32)),
        ("rglru_scan", lambda x, lam, ga, gx, b_a, b_i: rg_ops.rglru(
            x, lam, ga, gx, b_a=b_a, b_i=b_i), (x, lam, ga, gx, *b),
         rg_cost.work(2, 10, 32, torch.float32, torch.float32, False, True),
         rg_cost.bwd_work(2, 10, 32, torch.float32, True)),
        ("mlstm_scan", lambda q, k, v, ig, fg: ml_ops.mlstm_chunkwise(
            q, k, v, ig, fg)[0], (mq, mk, mv, ig, fg),
         ml_cost.work(2, 12, 2, 8, torch.float32, False),
         ml_cost.bwd_work(2, 12, 2, 8, torch.float32)),
    ]


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("index", range(4), ids=["flash_attention",
                                                 "moe_gmm", "rglru_scan",
                                                 "mlstm_scan"])
def test_kernel_call_counts_by_its_work(device, index):
    name, fn, inputs, work, bwd_work = _kernel_cases(device)[index]
    tot = _kernel_calls(fn, inputs)
    assert set(tot.kernels) == {name, name + "_bwd"}
    k, kb = tot.kernels[name], tot.kernels[name + "_bwd"]
    assert (k.calls, k.flops, k.bytes) == (1, *work)
    assert (kb.calls, kb.flops, kb.bytes) == (1, *bwd_work)


@pytest.mark.parametrize("index", range(4), ids=["flash_attention",
                                                 "moe_gmm", "rglru_scan",
                                                 "mlstm_scan"])
def test_wrappers_on_meta_return_empty_outputs_of_the_right_shapes(index):
    _, fn, inputs, _, _ = _kernel_cases("meta")[index]
    _, cpu_fn, cpu_inputs, _, _ = _kernel_cases("cpu")[index]
    with torch.no_grad():
        got = fn(*inputs)
        want = cpu_fn(*cpu_inputs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(t.device.type, t.shape, t.dtype) for t in got] == \
        [("meta", w.shape, w.dtype) for w in want]
    # the backward gives every input a gradient of its shape
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs[0].sum(), inputs)
    assert [(g.device.type, g.shape) for g in grads] == \
        [("meta", t.shape) for t in inputs]


@pytest.mark.parametrize("index", range(4), ids=["flash_attention",
                                                 "moe_gmm", "rglru_scan",
                                                 "mlstm_scan"])
def test_counting_on_the_cpu_keeps_values_and_gradients(index):
    """Under a counter the CPU wrappers run the plain version inside a
    recorded call: outputs and gradients are those without a counter, and
    those of the plain version itself."""
    _, fn, inputs, _, _ = _kernel_cases("cpu")[index]
    runs = []
    for counting in (False, True):
        with FlopCounter() if counting else torch.enable_grad():
            outs = fn(*inputs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            grads = torch.autograd.grad(outs[0].float().square().sum(),
                                        inputs)
        runs.append((outs, grads))
    # the recorded call's outputs are contiguous, as the kernels write
    # them, so a backward may sum in another order: float32 rounding
    for a, b in zip(*runs):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)
    # without a counter the wrapper is the plain version, bit for bit
    plain = {0: lambda q, k, v: fa_ref.reference_attention(
        q, k, v, causal=True, window=6),
        1: lambda xe, w1, w3, w2: gmm_ref.reference_expert_ffn(
            xe, {"w1": w1, "w3": w3, "w2": w2}, "swiglu",
            torch.tensor([8, 3, 0], dtype=torch.int32)),
        2: lambda x, lam, ga, gx, b_a, b_i: rg_ref.reference_rglru(
            x, lam, ga, gx, b_a=b_a, b_i=b_i),
        3: lambda q, k, v, ig, fg: ml_ref.reference_mlstm(
            q, k, v, ig, fg)[0]}[index]
    want = plain(*inputs)
    want = want if isinstance(want, tuple) else (want,)
    for x, y in zip(runs[0][0], want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_temporaries_exclude_arguments_and_free_what_dies():
    a = torch.empty(256, 256, device="meta")          # made before: no temp
    with FlopCounter() as fc:
        b = a * 2                                      # 256 KiB each
        c = (a + 1).view(-1)
        c.add_(1)                                      # in place: no new
        a.mul_(2)
        del b, c                                       # freed
        d = a * 3
    assert fc.totals.peak_live_bytes == 2 * 256 * 256 * 4
    del d
