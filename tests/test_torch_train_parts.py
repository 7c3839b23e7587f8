"""The rest of the port's training slice against the JAX package's, on the
CPU: LR schedules and ``adamw_update``, the synthetic batches, checkpoints
written by one and restored by the other (keep-last-k, LATEST, bf16), the
MessagePack codec against ``msgpack``, the plain flash-attention backward
against autodiff (the port's and ``jax.grad`` of the JAX package's plain
attention: its Pallas kernel has no gradient), the flash autograd
function's wiring, the grad guard of the kernels without a backward, and
the train CLI."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_arch as jax_arch
from repro.data import make_batch_iter as jax_batch_iter
from repro.kernels.flash_attention import ref as jax_flash_ref
from repro.models import registry as JR
from repro.models.config import ShapeSpec as JaxShapeSpec
from repro.optim import adamw as JA
from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.checkpoint.msgpack_codec import packb, unpackb
from repro_torch.configs import get_arch as torch_arch
from repro_torch.convert import (flatten_with_paths, opt_state_from_jax,
                                 opt_state_to_jax, params_from_jax,
                                 params_to_jax)
from repro_torch.data import PrefetchLoader, make_batch_iter
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import train as train_cli
from repro_torch.models import registry as R
from repro_torch.models.config import ShapeSpec
from repro_torch.optim import adamw as TA
from repro_torch.tree import tree_leaves, tree_map

ARCH = "minicpm-2b"


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_schedules_match_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=schedule)
    jfn = JA.make_schedule(JA.AdamWConfig(**kw))
    tfn = TA.make_schedule(TA.AdamWConfig(**kw))
    for step in (0, 1, 5, 10, 11, 50, 89, 90, 95, 100, 150):
        want = float(jfn(jnp.int32(step)))
        got = float(tfn(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), (step, got)


def _tree(rng):
    """A params-like tree with 2-D leaves (decayed) and 1-D ones (not)."""
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "blocks": [{"ln": rng.normal(size=(5,)).astype(np.float32),
                        "wq": rng.normal(size=(5, 4)).astype(np.float32)}],
            "b": rng.normal(size=(3,)).astype(np.float32)}


@pytest.mark.parametrize("clip_norm", [1e9, 0.5])
def test_adamw_update_matches_jax(clip_norm):
    rng = np.random.default_rng(0)
    params, grads1, grads2 = _tree(rng), _tree(rng), _tree(rng)
    kw = dict(lr=1e-2, clip_norm=clip_norm, warmup_steps=1, total_steps=5,
              weight_decay=0.1, schedule="cosine")
    jcfg, tcfg = JA.AdamWConfig(**kw), TA.AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    jst = JA.adamw_init(jp)
    tp = tree_map(torch.tensor, params)
    tst = TA.adamw_init(tp)
    for grads in (grads1, grads2):
        jp, jst, jm = JA.adamw_update(jax.tree.map(jnp.asarray, grads), jst,
                                      jp, jcfg)
        tp, tst, tm = TA.adamw_update(tree_map(torch.tensor, grads), tst, tp,
                                      tcfg)
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * float(jm[k])
    assert int(tst.step) == int(jst.step) == 2
    for got, want in ((tp, jp), (tst.m, jst.m), (tst.v, jst.v)):
        want = flatten_with_paths(jax.tree.map(np.asarray, want))
        got = flatten_with_paths(got)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       rtol=1e-5, atol=1e-7, err_msg=key)
    # 1-D leaves take no weight decay: with a zero gradient they stay put
    zero = tree_map(lambda a: torch.zeros(a.shape), params)
    tp2 = tree_map(torch.tensor, params)
    TA.adamw_update(zero, TA.adamw_init(tp2), tp2, tcfg)
    assert torch.equal(tp2["b"], torch.tensor(params["b"]))
    assert not torch.equal(tp2["w"], torch.tensor(params["w"]))


def test_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    want = float(JA.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(TA.global_norm(tree_map(torch.tensor, tree)))
    assert abs(got - want) <= 1e-6 * want


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("start_step", [0, 3])
def test_batches_match_jax(start_step):
    jc, tc = jax_arch(ARCH).reduced(), torch_arch(ARCH).reduced()
    jit = jax_batch_iter(jc, JaxShapeSpec("t", 48, 3, "train"), seed=7,
                         start_step=start_step)
    tit = make_batch_iter(tc, ShapeSpec("t", 48, 3, "train"), seed=7,
                          start_step=start_step)
    for _ in range(3):
        want, got = next(jit), next(tit)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetch_loader_keeps_order_and_stops():
    loader = PrefetchLoader(iter(range(5)), depth=2)
    assert list(loader) == [0, 1, 2, 3, 4]
    loader.close()


# --------------------------------------------------------------------------
# checkpoints, both ways
# --------------------------------------------------------------------------

def _jax_state(dtype="float32"):
    jc = dataclasses.replace(jax_arch(ARCH).reduced(), dtype=dtype)
    jp = jax.jit(lambda key: JR.init_params(key, jc)[0])(jax.random.key(1))
    st = JA.adamw_init(jp)
    rng = np.random.default_rng(2)
    # moments and step that are not zeros, so that a mix-up shows
    st = JA.AdamWState(
        step=jnp.int32(7),
        m=jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape),
                                             jnp.float32), st.m),
        v=jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape),
                                             jnp.float32), st.v))
    return jp, st


def _port_cfg():
    return torch_arch(ARCH).reduced()


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jp, jst = _jax_state()
    JaxCheckpointManager(str(tmp_path)).save(
        7, {"params": jp, "opt": jst}, meta={"arch": "x", "seed": 1})
    tc = _port_cfg()
    tparams = R.init_params(tc, 0, device="cpu", param_dtype=torch.float32)
    topt = TA.adamw_init(tparams)
    step, trees, meta = CheckpointManager(str(tmp_path), tc).restore_latest(
        {"params": tparams, "opt": topt})
    assert step == 7 and meta == {"arch": "x", "seed": 1}
    want_p = flatten_with_paths(jax.tree.map(np.asarray, jp))
    got_p = flatten_with_paths(params_to_jax(tc, trees["params"]))
    assert set(got_p) == set(want_p)
    for k in want_p:
        np.testing.assert_array_equal(got_p[k], want_p[k])
    step_, m, v = opt_state_to_jax(tc, trees["opt"])
    assert int(step_) == 7 and trees["opt"].step.dtype == torch.int32
    for got, want in ((m, jst.m), (v, jst.v)):
        want = flatten_with_paths(jax.tree.map(np.asarray, want))
        got = flatten_with_paths(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_port_checkpoint_restores_in_jax(tmp_path):
    jp, jst = _jax_state()
    tc = _port_cfg()
    tparams = params_from_jax(tc, jax.tree.map(np.asarray, jp))
    topt = opt_state_from_jax(tc, jax.tree.map(np.asarray, tuple(jst)))
    mgr = CheckpointManager(str(tmp_path), tc, keep=2)
    for s in (3, 5, 9):
        mgr.save(s, {"params": tparams, "opt": topt}, meta={"seed": s})
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000005",
                                            "step_00000009"]
    assert (tmp_path / "LATEST").read_text() == "9"
    assert latest_step(str(tmp_path)) == 9
    got = JaxCheckpointManager(str(tmp_path)).restore_latest(
        {"params": jp, "opt": JA.adamw_init(jp)})
    step, trees, meta = got
    assert step == 9 and meta == {"seed": 9}
    for got_t, want_t in ((trees["params"], jp), (trees["opt"], jst)):
        for g, w in zip(jax.tree.leaves(got_t), jax.tree.leaves(want_t)):
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_bf16_checkpoint_round_trips_both_ways(tmp_path):
    jp, _ = _jax_state()
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tc = _port_cfg()
    JaxCheckpointManager(str(tmp_path / "j")).save(1, {"params": jp16})
    tmpl = tree_map(lambda t: t.to(torch.bfloat16),
                    R.init_params(tc, 0, device="cpu"))
    _, trees, _ = CheckpointManager(str(tmp_path / "j"), tc).restore_latest(
        {"params": tmpl})
    want = flatten_with_paths(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jp16))
    got = flatten_with_paths(params_to_jax(tc, trees["params"]))
    assert all(t.dtype == torch.bfloat16
               for t in tree_leaves(trees["params"]))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # and back: the port writes bf16 bytes that JAX reads as bfloat16
    CheckpointManager(str(tmp_path / "t"), tc).save(
        2, {"params": trees["params"]})
    _, back, _ = JaxCheckpointManager(str(tmp_path / "t")).restore_latest(
        {"params": jp16})
    for g, w in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(jp16)):
        assert str(np.asarray(g).dtype) == "bfloat16"
        np.testing.assert_array_equal(np.asarray(g).astype(np.float32),
                                      np.asarray(w).astype(np.float32))


def test_restore_missing_leaf_raises(tmp_path):
    tc = _port_cfg()
    params = R.init_params(tc, 0, device="cpu", param_dtype=torch.float32)
    CheckpointManager(str(tmp_path), tc).save(1, {"params": params})
    with pytest.raises(KeyError, match="opt.step"):
        CheckpointManager(str(tmp_path), tc).restore_latest(
            {"params": params, "opt": TA.adamw_init(params)})


# --------------------------------------------------------------------------
# the manifest's MessagePack codec
# --------------------------------------------------------------------------

_OBJS = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
         2 ** 64 - 1, -1, -32, -33, -128, -129, -32769, -2 ** 31 - 1,
         -2 ** 63, 0.0, -2.25, 1e300, "", "a" * 31, "a" * 32, "é" * 200,
         "a" * 70000, [], list(range(15)),
         list(range(16)), list(range(70000)), {},
         {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
         {str(i): {"x": None} for i in range(70000)},
         {"step": 12, "meta": {"arch": "minicpm-2b", "seed": 0},
          "compress": False,
          "leaves": {"params['embed']": {"shape": [122753, 2304],
                                         "dtype": "float32"},
                     "opt.step": {"shape": [], "dtype": "int32"}}}]


@pytest.mark.parametrize("i", range(len(_OBJS)))
def test_msgpack_codec_matches_msgpack(i):
    obj = _OBJS[i]
    raw = msgpack.packb(obj)
    assert packb(obj) == raw
    assert unpackb(raw) == msgpack.unpackb(raw)


# --------------------------------------------------------------------------
# the flash-attention backward's plain version and the autograd function
# --------------------------------------------------------------------------

# (B, S, H, KH, Dh, causal, window): causal, a window that bites, GQA, MQA
_BWD_CASES = [(2, 33, 4, 4, 16, True, 0), (1, 40, 6, 2, 8, True, 7),
              (2, 25, 4, 1, 8, False, 0), (1, 30, 4, 2, 16, False, 9)]


def _qkv(B, S, H, KH, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, Dh)).astype(np.float32)
            for h in (H, KH, KH, H)]


@pytest.mark.parametrize("case", _BWD_CASES)
def test_plain_backward_matches_autograd_and_jax(case):
    B, S, H, KH, Dh, causal, window = case
    q, k, v, do = _qkv(B, S, H, KH, Dh)
    # the JAX package's plain attention, differentiated by jax.grad (C29:
    # its Pallas kernel has no gradient)
    out, vjp = jax.vjp(lambda q, k, v: jax_flash_ref.reference_attention(
        q, k, v, causal=causal, window=window), q, k, v)
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = fa_ref.reference_attention(tq, tk, tv, causal=causal, window=window)
    tgrads = torch.autograd.grad(o, (tq, tk, tv), torch.tensor(do))
    lse = fa_ref.reference_attention_lse(tq.detach(), tk.detach(),
                                         causal=causal, window=window)
    plain = fa_ref.reference_attention_bwd(
        tq.detach(), tk.detach(), tv.detach(), o.detach(), lse,
        torch.tensor(do), causal=causal, window=window)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(out),
                               atol=1e-5)
    for p, t, j in zip(plain, tgrads, jgrads):
        scale = float(t.abs().max())
        assert float((p - t).abs().max()) <= 1e-5 * scale
        assert float((p - torch.tensor(np.asarray(j))).abs().max()) <= \
            1e-5 * scale


def _fake_kernels(monkeypatch):
    """The kernels' C entry points' work done by the plain versions, so that
    the autograd function's wiring runs on the CPU; records the calls."""
    calls = {"fwd_lse": [], "bwd": 0}

    def rescale(q, scale):
        # the plain versions scale by 1/sqrt of q's (padded) head dim
        return q * (scale * q.shape[-1] ** 0.5)

    def launch(q, k, v, out, *, causal, window, scale=None, lse=None):
        q = rescale(q, scale)
        out.copy_(fa_ref.reference_attention(q, k, v, causal=causal,
                                             window=window))
        calls["fwd_lse"].append(lse is not None)
        if lse is not None:
            lse.copy_(fa_ref.reference_attention_lse(q, k, causal=causal,
                                                     window=window))

    def launch_bwd(q, k, v, out, dout, lse, dsum, dq, dk, dv, *, causal,
                   window, scale):
        assert dout.is_contiguous() and dsum.shape == lse.shape
        grads = fa_ref.reference_attention_bwd(rescale(q, scale), k, v, out,
                                               lse, dout, causal=causal,
                                               window=window)
        for dst, g in zip((rescale(grads[0], scale), grads[1], grads[2]),
                          (dq, dk, dv)):
            g.copy_(dst)
        calls["bwd"] += 1
    monkeypatch.setattr(fa_kernel, "launch", launch)
    monkeypatch.setattr(fa_kernel, "launch_bwd", launch_bwd)
    return calls


def test_flash_autograd_function_wiring(monkeypatch):
    """FlashAttentionFunction writes the log-sum-exp, saves what its
    backward needs and returns the backward's gradients, through the
    wrapper's padding of a head dim (16 -> 64) and copy of a view."""
    calls = _fake_kernels(monkeypatch)
    B, S, H, KH, Dh = 2, 20, 4, 2, 16
    q, k, v, do = _qkv(B, S, H, KH, Dh, seed=3)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    want = torch.autograd.grad(
        fa_ref.reference_attention(tq, tk, tv, causal=True, window=5),
        (tq, tk, tv), torch.tensor(do))
    qv = tq.transpose(1, 2).contiguous().transpose(1, 2)  # a strided view
    pq, pk, pv = fa_ops.kernel_layout(qv, tk, tv)
    assert pq.shape[-1] == 64
    out = fa_ops.FlashAttentionFunction.apply(pq, pk, pv, True, 5,
                                              1.0 / np.sqrt(Dh))
    got = torch.autograd.grad(out[..., :Dh], (tq, tk, tv), torch.tensor(do))
    assert calls == {"fwd_lse": [True], "bwd": 1}
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


@pytest.mark.parametrize("B,S,H,KH,Dh,want", [
    (1, 4096, 36, 36, 64, 1),    # minicpm-2b's train shape: 1152 blocks
    (4, 1000, 24, 8, 64, 1),     # granite's GQA prefill: 256 blocks
    (1, 4096, 16, 1, 256, 4),    # recurrentgemma's train shape: 64 blocks
    (4, 1000, 16, 1, 256, 4),    # and its prefill: 64 blocks
    (2, 65, 6, 1, 256, 6),       # 4 blocks: one head a share
    (2, 1, 8, 2, 64, 4),
])
def test_flash_bwd_splits_fill_the_card(B, S, H, KH, Dh, want):
    """The bf16 dK/dV pass splits a KV head's query heads only where its
    key tiles would not fill the card's 132 multiprocessors, and no share
    is empty."""
    splits = fa_kernel.bwd_splits(B, S, H, KH, Dh, 132)
    assert splits == want
    G = H // KH
    per = -(-G // splits)
    assert (splits - 1) * per < G <= splits * per


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------

def test_train_cli_lowers_loss_and_resumes(tmp_path, capsys):
    args = ["--arch", "minicpm-2b-smoke", "--device", "cpu", "--batch", "4",
            "--seq", "64", "--lr", "3e-3", "--warmup", "2", "--log-every",
            "3", "--ckpt-dir", str(tmp_path), "--ckpt-every", "6"]
    first = train_cli.main(args + ["--steps", "12"])
    assert first[-1]["nll"] < first[0]["nll"]
    assert latest_step(str(tmp_path)) == 12
    second = train_cli.main(args + ["--steps", "15", "--metrics-out",
                                    str(tmp_path / "m.json")])
    out = capsys.readouterr().out
    assert "auto-resumed from step 12" in out
    assert [h["step"] for h in second] == [13, 15]
    assert latest_step(str(tmp_path)) == 15
    assert (tmp_path / "m.json").exists()


def test_train_cli_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "minicpm-2b-smoke", "--steps", "1"])
