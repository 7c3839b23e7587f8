"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: a CUDA kernel has no CPU mode, so each test skips, with its
reason, where there is no CUDA device.  Whether there is one is decided
inside each test, so that every pytest worker collects the same tests.  On
the GPU machine (which has no JAX, so this file imports none):

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import kernel, ops, ref
from repro_torch.kernels.mlstm_scan import kernel as ml_kernel
from repro_torch.kernels.mlstm_scan import ops as ml_ops
from repro_torch.kernels.mlstm_scan import ref as ml_ref
from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as gmm_ref
from repro_torch.kernels.rglru_scan import kernel as rg_kernel
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import ref as rg_ref
from repro_torch.models import registry as R

pytestmark = pytest.mark.gpu

# kernel output rounded to bf16 vs a float32 plain version on the same
# inputs: half an ulp of |o| < 8 is <= 7.8e-3.  float32 vs float32 (no
# TF32): summation order only.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# moe_gmm, relative to the plain version's max |y|: bf16 rounds h and y to
# bf16 (2**-9 of the value each); float32 differs in summation order only.
GMM_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

# rglru_scan, relative to the plain version's max |y|: both compute in
# float32 from the same inputs and the kernel does not round its output;
# they differ by the last bits of exp/expm1/sqrt and a fused multiply-add
# per step, which the recurrence (a < 1) does not amplify.
RGLRU_RTOL = 1e-5
# the steps a block of csrc/rglru_scan.cu stages at once (its Block's W)
RGLRU_WINDOW = 64

# mlstm_scan, relative to the plain version's max |h| (and max |C|, |n|,
# |m|): both compute in float32 from the same inputs, in another order
# (chunks of 64 against the reference's, sums over Dh and S).
MLSTM_RTOL = 1e-4


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


def _qkv(B, S, H, KH, Dh, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((B, S, h, Dh), generator=g, device="cuda")
                 .to(dtype) for h in (H, KH, KH))


@pytest.mark.parametrize("B,S,H,KH,Dh,causal,window", [
    (4, 1000, 36, 36, 64, True, 0),      # minicpm-2b prefill
    (2, 1000, 32, 8, 120, True, 256),    # h2o-danube-3-4b, windowed
    (2, 1, 8, 2, 128, True, 0),
    (2, 136, 8, 2, 128, True, 0),
    (1, 200, 4, 1, 64, True, 17),
    (2, 136, 4, 4, 120, False, 0),
    (1, 130, 4, 2, 128, False, 50),
    (3, 64, 6, 3, 64, True, 64),
    (4, 1000, 16, 1, 256, True, 2048),   # recurrentgemma-9b LOCAL prefill
    (1, 2304, 16, 1, 256, True, 2048),   # MQA, the window bites
    (2, 136, 4, 1, 256, True, 0),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_matches_plain(B, S, H, KH, Dh, causal, window, dtype):
    _need_cuda()
    q, k, v = _qkv(B, S, H, KH, Dh, dtype)
    before = kernel.LAUNCHES
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.reference_attention(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    err = float((out.float() - want).abs().max())
    assert err <= TOL[dtype], err


# the edges of the bf16 kernel's tiles (192 query rows a block at Dh 64 and
# 128 above; k-tiles of 128 keys up to Dh 128 and 64 at Dh 256) and of the
# scalar kernel's (64)
@pytest.mark.parametrize("B,S,H,KH,Dh,causal,window", [
    (1, 1, 4, 1, 64, True, 0),
    (2, 63, 4, 4, 64, True, 0),
    (1, 64, 4, 1, 128, True, 0),
    (2, 65, 4, 2, 64, True, 0),
    (1, 127, 4, 4, 128, False, 0),
    (2, 128, 4, 1, 64, True, 0),
    (1, 129, 4, 2, 128, True, 0),
    (1, 257, 4, 1, 64, True, 0),
    (1, 257, 4, 4, 256, True, 0),
    (1, 300, 4, 1, 64, True, 1),        # each row sees only itself
    (1, 300, 4, 4, 256, True, 1),
    (2, 400, 4, 2, 64, True, 100),      # a window no tile size divides
    (1, 400, 4, 1, 256, True, 77),
    (1, 300, 4, 4, 128, False, 100),    # non-causal window
    (1, 330, 4, 1, 64, False, 0),       # rows past S in the last tile
    (2, 193, 4, 2, 64, True, 0),
    (1, 385, 4, 1, 64, False, 0),
    (2, 201, 4, 2, 120, True, 0),       # Dh 120 with a ragged S
    (1, 129, 4, 1, 120, False, 50),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_at_tile_edges(B, S, H, KH, Dh, causal, window, dtype):
    _need_cuda()
    q, k, v = _qkv(B, S, H, KH, Dh, dtype, seed=S)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    want = ref.reference_attention(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    err = float((out.float() - want).abs().max())
    assert err <= TOL[dtype], err


def test_flash_kernel_counts_bf16_on_wgmma_and_float32_on_scalar():
    _need_cuda()
    for dtype, route in ((torch.bfloat16, "wgmma_bf16"),
                         (torch.float32, "scalar_f32")):
        q, k, v = _qkv(1, 200, 4, 2, 64, dtype)
        before = dict(kernel.LAUNCHES_BY_ROUTE), kernel.LAUNCHES
        ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert kernel.LAUNCHES == before[1] + 1
        assert kernel.LAUNCHES_BY_ROUTE == {
            r: n + (r == route) for r, n in before[0].items()}


def test_flash_kernel_refuses_a_misaligned_bf16_view():
    """TMA needs 16-byte aligned tensors, and the kernel no longer refuses a
    contiguous bf16 view one element into its storage: the wrapper copies it
    to a fresh, aligned tensor, and the kernel runs on it (counted on its
    route) within the bf16 bar."""
    _need_cuda()
    shape = (1, 64, 4, 64)
    storage = torch.randn(4 * 64 * 64 + 1, device="cuda").to(torch.bfloat16)
    q = storage[1:].view(shape)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    _, k, v = _qkv(1, 64, 4, 4, 64, torch.bfloat16)
    for args in ((q, k, v), (k, q, v), (k, v, q)):
        before = kernel.LAUNCHES_BY_ROUTE["wgmma_bf16"]
        out = ops.flash_attention(*args)
        torch.cuda.synchronize()
        assert kernel.LAUNCHES_BY_ROUTE["wgmma_bf16"] == before + 1
        want = ref.reference_attention(*(t.float() for t in args))
        err = float((out.float() - want).abs().max())
        assert err <= TOL[torch.bfloat16], err


def test_flash_kernel_rejects_what_it_does_not_take():
    """Head dims past 256, dtypes other than float32 and bf16, and tensors
    on more than one device raise before any launch; a head dim the kernel
    is not built for (96) and a transposed view run on it (the wrapper pads
    and copies; their results are held in the tests below)."""
    _need_cuda()
    before = kernel.LAUNCHES
    q, k, v = _qkv(1, 16, 2, 2, 288, torch.float32)
    with pytest.raises(ValueError, match="head dim 288"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 16, 2, 2, 64, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 16, 2, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention(q, k.cpu(), v)
    assert kernel.LAUNCHES == before
    q_strided = torch.randn((1, 2, 16, 64), device="cuda").transpose(1, 2)
    ops.flash_attention(q_strided, k, v)
    q, k, v = _qkv(1, 16, 2, 2, 96, torch.float32)
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == before + 2 and out.shape == q.shape


# head dims the kernel is not built for: zero-padded to the next supported
# one (16 -> 64, the reduced configs; 80 -> 120, hubert-xlarge; 96 -> 120)
@pytest.mark.parametrize("Dh", [16, 80, 96])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 33),
                                           (False, 0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_pads_other_head_dims(Dh, causal, window, dtype):
    _need_cuda()
    q, k, v = _qkv(2, 150, 4, 2, Dh, dtype, seed=Dh)
    route = kernel.ROUTES[dtype][1]
    before = kernel.LAUNCHES_BY_ROUTE[route]
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES_BY_ROUTE[route] == before + 1
    assert out.dtype == dtype and out.shape == q.shape and \
        out.is_contiguous()
    want = ref.reference_attention(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    err = float((out.float() - want).abs().max())
    assert err <= TOL[dtype], err


# views the kernel cannot address as they are: transposed from a (B, heads,
# S, Dh) layout, a slice of a fused QKV projection, and (bf16) a contiguous
# view one element into its storage; each is copied and runs on the kernel
@pytest.mark.parametrize("view", ["transposed", "fused-qkv", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_takes_views(view, dtype):
    _need_cuda()
    B, S, H, Dh = 2, 130, 4, 64
    g = torch.Generator(device="cuda").manual_seed(7)
    if view == "transposed":
        q, k, v = (torch.randn((B, H, S, Dh), generator=g, device="cuda")
                   .to(dtype).transpose(1, 2) for _ in range(3))
    elif view == "fused-qkv":
        qkv = torch.randn((B, S, 3 * H, Dh), generator=g,
                          device="cuda").to(dtype)
        q, k, v = qkv.split(H, dim=2)
    else:
        flat = torch.randn(3 * B * S * H * Dh + 1, generator=g,
                           device="cuda").to(dtype)
        q, k, v = flat[1:].view(3, B, S, H, Dh).unbind(0)
        assert dtype == torch.float32 or q.data_ptr() % 16 == 2
    assert view == "misaligned" or not q.is_contiguous()
    route = kernel.ROUTES[dtype][1]
    before = kernel.LAUNCHES_BY_ROUTE[route]
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES_BY_ROUTE[route] == before + 1
    want = ref.reference_attention(q.float(), k.float(), v.float())
    err = float((out.float() - want).abs().max())
    assert err <= TOL[dtype], err


def test_model_on_gpu_matches_plain_on_cpu():
    """Kernels on (CUDA) against kernels off (the plain version on the CPU)."""
    _need_cuda()
    cfg = dataclasses.replace(get_arch("h2o-danube-3-4b").reduced(),
                              n_kv_heads=2, head_dim=64, dtype="float32")
    params = R.init_params(cfg, 0, device="cpu")
    params_gpu = {k: ([{g: {n: w.cuda() for n, w in sub.items()}
                        for g, sub in lay.items()} for lay in v]
                      if k == "layers" else v.cuda())
                  for k, v in params.items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 150),
                         generator=torch.Generator().manual_seed(0))
    before = kernel.LAUNCHES
    on = R.forward_logits(params_gpu, cfg, {"tokens": toks}, device="cuda")
    assert kernel.LAUNCHES == before + cfg.n_layers
    off = R.forward_logits(params, cfg, {"tokens": toks}, device="cpu")
    assert float((on.cpu() - off).abs().max()) < 1e-3


def _gmm_inputs(E, C, d, f, gated, dtype, pad=0, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xe = torch.randn((E, C, d), generator=g, device="cuda")
    xe[:, C - pad:] = 0.0                       # zero pad rows, as in buckets
    p = {"w1": torch.randn((E, d, f), generator=g, device="cuda") / d ** 0.5,
         "w2": torch.randn((E, f, d), generator=g, device="cuda") / f ** 0.5}
    if gated:
        p["w3"] = torch.randn((E, d, f), generator=g, device="cuda") / d ** 0.5
    return xe.to(dtype), {k: w.to(dtype) for k, w in p.items()}


def _gmm_route(dtype, d, f):
    """The route of a fresh, contiguous input (ops.kernel_route's rule)."""
    if dtype == torch.float32:
        return "scalar_f32"
    return "wgmma_bf16" if d % 8 == 0 and f % 8 == 0 else "wmma_bf16"


def _gmm_check(xe, p, act, counts, out):
    """out within GMM_RTOL of the plain version (in float32 on the same
    inputs), and rows at or past ``counts`` exactly 0."""
    want = gmm_ref.reference_expert_ffn(
        xe.float(), {k: w.float() for k, w in p.items()}, act, counts)
    rel = float((out.float() - want).abs().max() / want.abs().max())
    assert rel <= GMM_RTOL[xe.dtype], rel
    if counts is not None:
        rows = torch.arange(xe.shape[1], device=xe.device)
        pads = rows[None, :] >= counts[:, None]
        assert not out[pads].any()


@pytest.mark.parametrize("E,C,d,f,act,gated,pad", [
    (40, 1000, 1536, 512, "swiglu", True, 0),    # granite-moe prefill
    (40, 8, 1536, 512, "swiglu", True, 7),       # granite-moe decode
    (4, 1, 256, 512, "swiglu", True, 0),
    (4, 136, 256, 512, "swiglu", True, 17),
    (3, 100, 211, 333, "swiglu", True, 9),       # no tile divides d or f
    (4, 136, 256, 512, "geglu", True, 0),
    (2, 70, 128, 96, "gelu", False, 0),
    (4, 136, 256, 512, "relu2", False, 17),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_gmm_kernel_matches_plain(E, C, d, f, act, gated, pad, dtype):
    _need_cuda()
    xe, p = _gmm_inputs(E, C, d, f, gated, dtype, pad)
    route = gmm_ops.kernel_route(xe, p["w1"], p.get("w3"), p["w2"])
    assert route == _gmm_route(dtype, d, f)
    before = gmm_kernel.LAUNCHES, dict(gmm_kernel.LAUNCHES_BY_ROUTE)
    out = gmm_ops.expert_ffn(xe, p, act)
    torch.cuda.synchronize()
    assert gmm_kernel.LAUNCHES == before[0] + 1
    assert gmm_kernel.LAUNCHES_BY_ROUTE == {
        r: n + (r == route) for r, n in before[1].items()}
    assert out.dtype == dtype and out.shape == xe.shape
    want = gmm_ref.reference_expert_ffn(
        xe.float(), {k: w.float() for k, w in p.items()}, act)
    rel = float((out.float() - want).abs().max() / want.abs().max())
    assert rel <= GMM_RTOL[dtype], rel
    if pad:
        assert not out[:, C - pad:].any()       # act(0) * 0 = 0 for pad rows


# the wgmma route's tile edges: 64-row tiles for buckets of at most 64
# rows, 128-row tiles above; the last is granite's prefill bucket
@pytest.mark.parametrize("C", [1, 63, 64, 65, 127, 128, 129, 1000])
def test_moe_gmm_wgmma_route_at_tile_edges(C):
    _need_cuda()
    xe, p = _gmm_inputs(6, C, 256, 384, True, torch.bfloat16, seed=C)
    assert gmm_ops.kernel_route(xe, p["w1"], p["w3"], p["w2"]) == \
        "wgmma_bf16"
    before = gmm_kernel.LAUNCHES_BY_ROUTE["wgmma_bf16"]
    out = gmm_ops.expert_ffn(xe, p, "swiglu")
    torch.cuda.synchronize()
    assert gmm_kernel.LAUNCHES_BY_ROUTE["wgmma_bf16"] == before + 1
    _gmm_check(xe, p, "swiglu", None, out)


def _bucket_counts(E, C, seed):
    """Fills of E buckets of C: an empty one, a full one, the rest at
    random (a few empty) and the rows past each fill zero, as the gather
    dispatch leaves them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    counts = torch.randint(0, C + 1, (E,), generator=g, device="cuda")
    counts[0], counts[-1] = 0, C
    counts[1::5] = 0
    return counts.to(torch.int32)


# (E, C, d, f, act, gated): bucket fills of 0, partial and full on every
# route; d and f not multiples of 64 (TMA clips them) on the wgmma route
@pytest.mark.parametrize("E,C,d,f,act,gated", [
    (40, 8, 1536, 512, "swiglu", True),       # granite decode
    (40, 1000, 1536, 512, "swiglu", True),    # granite prefill
    (8, 200, 200, 328, "geglu", True),
    (6, 130, 136, 72, "relu2", False),
    (5, 40, 64, 64, "gelu", False),
    (3, 100, 211, 333, "swiglu", True),       # bf16 on wmma_bf16
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_gmm_skips_rows_past_counts(E, C, d, f, act, gated, dtype):
    _need_cuda()
    counts = _bucket_counts(E, C, seed=E * C)
    xe, p = _gmm_inputs(E, C, d, f, gated, dtype, seed=C)
    rows = torch.arange(C, device="cuda")
    xe = xe * (rows[None, :] < counts[:, None])[..., None].to(dtype)
    route = gmm_ops.kernel_route(xe, p["w1"], p.get("w3"), p["w2"])
    assert route == _gmm_route(dtype, d, f)
    before = gmm_kernel.LAUNCHES_BY_ROUTE[route]
    out = gmm_ops.expert_ffn(xe, p, act, counts)
    torch.cuda.synchronize()
    assert gmm_kernel.LAUNCHES_BY_ROUTE[route] == before + 1
    _gmm_check(xe, p, act, counts, out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_gmm_zeroes_rows_past_counts_whatever_they_hold(dtype):
    """Rows at or past counts[e] are pads by contract: y is 0 there even
    where xe holds data, and the live rows match the plain version."""
    _need_cuda()
    E, C = 6, 150
    counts = _bucket_counts(E, C, seed=3)
    xe, p = _gmm_inputs(E, C, 128, 192, True, dtype, seed=3)
    out = gmm_ops.expert_ffn(xe, p, "swiglu", counts)
    torch.cuda.synchronize()
    _gmm_check(xe, p, "swiglu", counts, out)


# a full-width mixtral expert FFN (d 4096, f 14336): the down product sums
# 14336 terms in one float32 accumulator
def test_moe_gmm_wgmma_route_at_mixtral_width():
    _need_cuda()
    E, C = 8, 300
    counts = _bucket_counts(E, C, seed=8)
    xe, p = _gmm_inputs(E, C, 4096, 14336, True, torch.bfloat16, seed=8)
    assert gmm_ops.kernel_route(xe, p["w1"], p["w3"], p["w2"]) == \
        "wgmma_bf16"
    for c in (None, counts):
        out = gmm_ops.expert_ffn(xe, p, "swiglu", c)
        torch.cuda.synchronize()
        _gmm_check(xe, p, "swiglu", c, out)


def test_moe_gmm_takes_bf16_that_tma_cannot_address_on_wmma():
    """A bf16 xe one element into its storage, and odd d and f, take
    wmma_bf16 by the explicit rule, counted there, within the bar."""
    _need_cuda()
    E, C, d, f = 3, 70, 128, 96
    xe, p = _gmm_inputs(E, C, d, f, True, torch.bfloat16)
    storage = torch.empty(E * C * d + 1, dtype=torch.bfloat16, device="cuda")
    x_view = storage[1:].view(E, C, d)
    x_view.copy_(xe)
    assert x_view.is_contiguous() and x_view.data_ptr() % 16 == 2
    for x, q in ((x_view, p), _gmm_inputs(3, 100, 211, 333, True,
                                          torch.bfloat16)):
        assert gmm_ops.kernel_route(x, q["w1"], q["w3"], q["w2"]) == \
            "wmma_bf16"
        before = gmm_kernel.LAUNCHES_BY_ROUTE["wmma_bf16"]
        out = gmm_ops.expert_ffn(x, q, "swiglu")
        torch.cuda.synchronize()
        assert gmm_kernel.LAUNCHES_BY_ROUTE["wmma_bf16"] == before + 1
        _gmm_check(x, q, "swiglu", None, out)


def test_moe_gmm_casts_weights_to_the_input_dtype():
    _need_cuda()
    xe, p = _gmm_inputs(2, 16, 64, 64, True, torch.float32)
    out = gmm_ops.expert_ffn(xe.bfloat16(), p, "swiglu")
    assert out.dtype == torch.bfloat16
    want = gmm_ref.reference_expert_ffn(
        xe.bfloat16().float(),
        {k: w.bfloat16().float() for k, w in p.items()}, "swiglu")
    rel = float((out.float() - want).abs().max() / want.abs().max())
    assert rel <= GMM_RTOL[torch.bfloat16], rel


def test_moe_gmm_rejects_what_it_does_not_take():
    _need_cuda()
    xe, p = _gmm_inputs(2, 16, 64, 64, True, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gmm_ops.expert_ffn(xe.half(), p, "swiglu")
    with pytest.raises(ValueError, match="contiguous"):
        gmm_ops.expert_ffn(xe.transpose(0, 1).contiguous().transpose(0, 1),
                           p, "swiglu")
    with pytest.raises(ValueError, match="one CUDA device"):
        gmm_ops.expert_ffn(xe, {**p, "w2": p["w2"].cpu()}, "swiglu")
    with pytest.raises(ValueError, match="unknown act"):
        gmm_ops.expert_ffn(xe, p, "tanh")
    with pytest.raises(ValueError, match="w2"):
        gmm_ops.expert_ffn(xe, {**p, "w2": p["w1"][:, :, :32]}, "swiglu")
    with pytest.raises(ValueError, match="counts must be int32"):
        gmm_ops.expert_ffn(xe, p, "swiglu", torch.ones(2, device="cuda",
                                                       dtype=torch.long))
    with pytest.raises(ValueError, match="one CUDA device"):
        gmm_ops.expert_ffn(xe, p, "swiglu", torch.ones(2, dtype=torch.int32))


def test_moe_model_on_gpu_matches_plain_on_cpu():
    """granite-moe reduced through both kernels (CUDA) against the plain
    versions on the CPU, with the gather dispatch."""
    _need_cuda()
    cfg = dataclasses.replace(get_arch("granite-moe-3b-a800m").reduced(),
                              n_kv_heads=2, head_dim=64, dtype="float32")
    params = R.init_params(cfg, 0, device="cpu")
    params_gpu = {k: ([{g: {n: w.cuda() for n, w in sub.items()}
                        for g, sub in lay.items()} for lay in v]
                      if k == "layers" else v.cuda())
                  for k, v in params.items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 150),
                         generator=torch.Generator().manual_seed(0))
    before = gmm_kernel.LAUNCHES, kernel.LAUNCHES
    on = R.forward_logits(params_gpu, cfg, {"tokens": toks},
                          moe_dispatch="gather", device="cuda")
    assert (gmm_kernel.LAUNCHES, kernel.LAUNCHES) == \
        (before[0] + cfg.n_layers, before[1] + cfg.n_layers)
    off = R.forward_logits(params, cfg, {"tokens": toks},
                           moe_dispatch="gather", device="cpu")
    assert float((on.cpu() - off).abs().max()) < 1e-3


def _scan_inputs(B, S, D, x_dtype, g_dtype, seed=0, u=(0.9, 0.999)):
    """x, lam (a in [u0, u1] at zero gate), ga, gx, h0, b_a, b_i."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = u[0] + (u[1] - u[0]) * torch.rand((D,), generator=g, device="cuda")
    lam = torch.log(torch.expm1(-torch.log(u) / rg_ref.RGLRU_C))
    x, ga, gx = (torch.randn((B, S, D), generator=g, device="cuda")
                 for _ in range(3))
    h0 = torch.randn((B, D), generator=g, device="cuda")
    b_a, b_i = (0.5 * torch.randn((D,), generator=g, device="cuda")
                for _ in range(2))
    return x.to(x_dtype), lam, ga.to(g_dtype), gx.to(g_dtype), h0, b_a, b_i


@pytest.mark.parametrize("B,S,D,with_h0", [
    (4, 1000, 4096, False),    # recurrentgemma-9b prefill
    (2, 136, 128, False),      # shapes the Pallas grid drops (ROADMAP C2)
    (2, 128, 640, False),
    (12, 64, 128, False),
    (3, 1, 256, False),        # a single step
    (3, 77, 200, False),       # odd S and D
    (3, 77, 200, True),        # with an initial state
    # the window's and the segments' edges; D = 77 is not a multiple of 8
    # (staged with plain loads), 200 and 4100 not of the block's 64 channels
    (1, 1, 96, True),
    (3, RGLRU_WINDOW - 1, 77, False),
    (1, RGLRU_WINDOW, 200, True),
    (12, RGLRU_WINDOW + 1, 96, True),
    (2, 2 * RGLRU_WINDOW + 1, 77, True),
    (1, 2 * RGLRU_WINDOW + 1, 4100, False),
])
@pytest.mark.parametrize("x_dtype,g_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("route", ["gates", "fused_bias"])
def test_rglru_kernel_matches_plain(B, S, D, with_h0, x_dtype, g_dtype,
                                    route):
    """The kernel on ``route`` against the plain version on the same
    inputs: fused_bias hands over bias-free products and the biases,
    gates the whole gates."""
    _need_cuda()
    x, lam, ga, gx, h0, b_a, b_i = _scan_inputs(B, S, D, x_dtype, g_dtype)
    h0 = h0 if with_h0 else None
    bias = dict(b_a=b_a, b_i=b_i) if route == "fused_bias" else {}
    before = rg_kernel.LAUNCHES, rg_kernel.LAUNCHES_BY_ROUTE[route]
    y, h = rg_ops.rglru(x, lam, ga, gx, h0, **bias)
    torch.cuda.synchronize()
    assert (rg_kernel.LAUNCHES, rg_kernel.LAUNCHES_BY_ROUTE[route]) == \
        (before[0] + 1, before[1] + 1)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == x.shape and h.shape == (B, D)
    wy, wh = rg_ref.reference_rglru(x, lam, ga, gx, h0, **bias)
    scale = float(wy.abs().max())
    assert float((y - wy).abs().max()) <= RGLRU_RTOL * scale
    assert float((h - wh).abs().max()) <= RGLRU_RTOL * scale
    assert torch.equal(h, y[:, -1])


@pytest.mark.parametrize("S", [1000, 4096])
@pytest.mark.parametrize("route", ["gates", "fused_bias"])
def test_rglru_kernel_long_memory_against_float64(S, route):
    """a up to 0.9999 over thousands of steps, from h0: the kernel's
    segment products are the one rounding the sequential order does not
    have.  Its error against the float64 recurrence, relative to max |y|,
    may be at most twice the plain version's own and at most RGLRU_RTOL.
    (At chip_smoke.py's long-memory cases on an H100 the kernel is 1.7e-6
    and 4.2e-6 from float64 at S 1000 and 4096, the plain version 1.1e-5
    and 3.2e-5: the plain version is no yardstick at 1e-5 here.)"""
    _need_cuda()
    x, lam, ga, gx, h0, b_a, b_i = _scan_inputs(
        2, S, 512, torch.bfloat16, torch.bfloat16, seed=2, u=(0.999, 0.9999))
    truth = rg_ref.oracle_rglru(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
    if route == "gates":
        ga, gx, bias = ga + b_a, gx + b_i, {}
    else:
        bias = dict(b_a=b_a, b_i=b_i)
    y, _ = rg_ops.rglru(x, lam, ga, gx, h0, **bias)
    wy, _ = rg_ref.reference_rglru(x, lam, ga, gx, h0, **bias)
    scale = float(truth.abs().max())
    err = float((y.double() - truth).abs().max()) / scale
    plain_err = float((wy.double() - truth).abs().max()) / scale
    assert err <= 2 * plain_err and err <= RGLRU_RTOL, (err, plain_err)


def test_rglru_kernel_rejects_what_it_does_not_take():
    _need_cuda()
    x, lam, ga, gx, h0, b_a, b_i = _scan_inputs(2, 16, 64, torch.float32,
                                                torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rg_ops.rglru(x.half(), lam, ga, gx)
    with pytest.raises(ValueError, match="one dtype"):
        rg_ops.rglru(x, lam, ga, gx.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        rg_ops.rglru(x.transpose(0, 1).contiguous().transpose(0, 1), lam,
                     ga, gx)
    with pytest.raises(ValueError, match="one CUDA device"):
        rg_ops.rglru(x, lam, ga.cpu(), gx)
    with pytest.raises(ValueError, match="one CUDA device"):
        rg_ops.rglru(x, lam, ga, gx, b_a=b_a.cpu(), b_i=b_i)
    with pytest.raises(ValueError, match="b_a must be float32"):
        rg_ops.rglru(x, lam, ga, gx, b_a=b_a.bfloat16(), b_i=b_i)
    with pytest.raises(ValueError, match="both gate biases"):
        rg_ops.rglru(x, lam, ga, gx, b_i=b_i)
    with pytest.raises(ValueError, match=r"b_i \(32,\)"):
        rg_ops.rglru(x, lam, ga, gx, b_a=b_a, b_i=b_i[:32])


def test_griffin_model_on_gpu_matches_plain_on_cpu():
    """recurrentgemma-9b reduced at head dim 64 through both kernels (CUDA)
    against the plain versions on the CPU: forward, prefill and decode."""
    _need_cuda()
    cfg = dataclasses.replace(get_arch("recurrentgemma-9b").reduced(),
                              head_dim=64, dtype="float32")
    params = R.init_params(cfg, 0, device="cpu")
    params_gpu = {k: ([{g: {n: w.cuda() for n, w in sub.items()}
                        for g, sub in lay.items()} for lay in v]
                      if k == "layers" else v.cuda())
                  for k, v in params.items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 150),
                         generator=torch.Generator().manual_seed(0))
    n_rglru = sum(k == "rglru" for k in
                  (cfg.block_pattern[n % cfg.pattern_period]
                   for n in range(cfg.n_layers)))
    before = (rg_kernel.LAUNCHES, rg_kernel.LAUNCHES_BY_ROUTE["fused_bias"],
              kernel.LAUNCHES)
    on = R.forward_logits(params_gpu, cfg, {"tokens": toks}, device="cuda")
    # every RG-LRU layer on the fused route: the gate biases added in the
    # kernel
    assert (rg_kernel.LAUNCHES, rg_kernel.LAUNCHES_BY_ROUTE["fused_bias"],
            kernel.LAUNCHES) == (before[0] + n_rglru, before[1] + n_rglru,
                                 before[2] + cfg.n_layers - n_rglru)
    off = R.forward_logits(params, cfg, {"tokens": toks}, device="cpu")
    assert float((on.cpu() - off).abs().max()) < 1e-3
    lg_on, c_on = R.prefill(params_gpu, cfg, {"tokens": toks[:, :140]},
                            cache_len=150, device="cuda")
    lg_off, c_off = R.prefill(params, cfg, {"tokens": toks[:, :140]},
                              cache_len=150, device="cpu")
    for t in range(140, 143):
        lg_on, c_on = R.decode_step(params_gpu, cfg, toks[:, t:t + 1], t,
                                    c_on, device="cuda")
        lg_off, c_off = R.decode_step(params, cfg, toks[:, t:t + 1], t,
                                      c_off, device="cpu")
        assert float((lg_on.cpu() - lg_off).abs().max()) < 1e-3


def _mlstm_inputs(B, S, H, Dh, dtype, with_init=False, stress=False, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    q, k, v = randn(B, S, H, Dh), randn(B, S, H, Dh), randn(B, S, H, Dh)
    ig, fg = randn(B, S, H), 3.0 + randn(B, S, H)
    if stress:      # as chip_smoke.py's stress case, keys near their queries
        ig, fg, k = ig + 90.0, fg - 12.0, q + 0.5 * k
    init = (randn(B, H, Dh, Dh), randn(B, H, Dh), randn(B, H)) \
        if with_init else None
    return (q.to(dtype), k.to(dtype), v.to(dtype), ig, fg), init


@pytest.mark.parametrize("B,S,H,Dh,with_init,stress", [
    (4, 1000, 4, 1024, False, False),  # xlstm-1.3b prefill
    (2, 37, 4, 512, False, False),     # S not a multiple of the chunk
    (3, 1, 4, 1024, False, False),     # a single step
    (2, 200, 4, 32, False, False),     # xlstm-1.3b reduced's head dim
    (1, 1000, 1, 1024, False, False),  # one head
    (2, 136, 4, 512, True, False),     # from an initial state
    (2, 1000, 4, 1024, False, True),   # the stabiliser under stress
    (1, 100, 2, 1300, False, False),   # C past shared memory
    (2, 127, 2, 256, False, False),    # the wgmma route's chunk (128): less,
    (2, 128, 2, 256, True, False),     # one whole chunk,
    (2, 129, 2, 256, False, False),    # one step more,
    (1, 257, 2, 128, True, False),     # two chunks and one step
    (2, 150, 2, 96, True, False),      # Dh not a multiple of 64
    (1, 50, 1, 37, True, False),       # H * Dh odd: TMA cannot address it
    (1, 2600, 16, 1024, True, False),  # two segments of the wgmma route
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mlstm_kernel_matches_plain(B, S, H, Dh, with_init, stress, dtype):
    _need_cuda()
    xs, init = _mlstm_inputs(B, S, H, Dh, dtype, with_init, stress)
    route = "scalar_f32" if dtype == torch.float32 else \
        "wgmma_bf16" if Dh % 8 == 0 else "scalar_bf16"
    before = ml_kernel.LAUNCHES, ml_kernel.LAUNCHES_BY_ROUTE[route]
    h, state = ml_ops.mlstm_chunkwise(*xs, chunk=256, init_state=init)
    torch.cuda.synchronize()
    assert (ml_kernel.LAUNCHES, ml_kernel.LAUNCHES_BY_ROUTE[route]) == \
        (before[0] + 1, before[1] + 1)
    assert h.dtype == torch.float32 and h.shape == xs[0].shape
    wh, wstate = ml_ref.reference_mlstm(*xs, chunk=256, init_state=init)
    for name, got, want in zip("hCnm", (h,) + state, (wh,) + wstate):
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= MLSTM_RTOL, (name, rel)


def test_mlstm_kernel_counts_bf16_on_wgmma_and_float32_on_scalar():
    """The route follows dtype and shape: bf16 that TMA can address on
    wgmma_bf16, a bf16 view one element into its storage on scalar_bf16,
    float32 on scalar_f32; one count per call on one route."""
    _need_cuda()
    assert ml_kernel.chunk("wgmma_bf16") == ml_ref.WGMMA_CHUNK
    xs, _ = _mlstm_inputs(2, 130, 2, 64, torch.bfloat16)
    storage = torch.randn(2 * 130 * 2 * 64 + 1, device="cuda").bfloat16()
    q_off = storage[1:].view(xs[0].shape)
    assert q_off.is_contiguous() and q_off.data_ptr() % 16 == 2
    q_off.copy_(xs[0])
    want, _ = ml_ref.reference_mlstm(*xs, chunk=256)
    for args, route in ((xs, "wgmma_bf16"), ((q_off,) + xs[1:], "scalar_bf16"),
                        ((xs[0].float(), xs[1].float(), xs[2].float())
                         + xs[3:], "scalar_f32")):
        assert ml_ops.kernel_route(*args[:3]) == route
        before = dict(ml_kernel.LAUNCHES_BY_ROUTE), ml_kernel.LAUNCHES
        h, _ = ml_ops.mlstm_chunkwise(*args, chunk=256)
        torch.cuda.synchronize()
        assert ml_kernel.LAUNCHES == before[1] + 1
        assert ml_kernel.LAUNCHES_BY_ROUTE == {
            r: n + (r == route) for r, n in before[0].items()}
        rel = float((h - want).abs().max() / want.abs().max())
        assert rel <= MLSTM_RTOL, (route, rel)


def test_mlstm_kernel_rejects_what_it_does_not_take():
    _need_cuda()
    (q, k, v, ig, fg), init = _mlstm_inputs(2, 16, 2, 64, torch.float32,
                                            with_init=True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ml_ops.mlstm_chunkwise(q.half(), k.half(), v.half(), ig, fg)
    with pytest.raises(ValueError, match="one dtype"):
        ml_ops.mlstm_chunkwise(q, k.bfloat16(), v, ig, fg)
    with pytest.raises(ValueError, match="contiguous"):
        ml_ops.mlstm_chunkwise(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v, ig, fg)
    with pytest.raises(ValueError, match="one CUDA device"):
        ml_ops.mlstm_chunkwise(q, k, v, ig, fg,
                               init_state=(init[0].cpu(),) + init[1:])


def test_xlstm_model_on_gpu_matches_plain_on_cpu():
    """xlstm-1.3b reduced through mlstm_scan (CUDA) against the plain
    version on the CPU: forward, prefill and decode."""
    _need_cuda()
    cfg = dataclasses.replace(get_arch("xlstm-1.3b").reduced(),
                              dtype="float32")
    params = R.init_params(cfg, 0, device="cpu")
    params_gpu = {k: ([{g: {n: w.cuda() for n, w in sub.items()}
                        for g, sub in lay.items()} for lay in v]
                      if k == "layers" else v.cuda())
                  for k, v in params.items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 150),
                         generator=torch.Generator().manual_seed(0))
    n_mlstm = cfg.n_layers // 2
    before = ml_kernel.LAUNCHES, kernel.LAUNCHES
    on = R.forward_logits(params_gpu, cfg, {"tokens": toks}, device="cuda")
    assert (ml_kernel.LAUNCHES, kernel.LAUNCHES) == \
        (before[0] + n_mlstm, before[1])
    off = R.forward_logits(params, cfg, {"tokens": toks}, device="cpu")
    assert float((on.cpu() - off).abs().max()) < 1e-3
    lg_on, c_on = R.prefill(params_gpu, cfg, {"tokens": toks[:, :140]},
                            device="cuda")
    lg_off, c_off = R.prefill(params, cfg, {"tokens": toks[:, :140]},
                              device="cpu")
    for t in range(140, 143):
        lg_on, c_on = R.decode_step(params_gpu, cfg, toks[:, t:t + 1], t,
                                    c_on, device="cuda")
        lg_off, c_off = R.decode_step(params, cfg, toks[:, t:t + 1], t,
                                      c_off, device="cpu")
        assert float((lg_on.cpu() - lg_off).abs().max()) < 1e-3


def test_bf16_xlstm_model_on_wgmma_is_as_close_to_float32_as_plain():
    """xlstm-1.3b reduced with two heads, so an mLSTM head dim of 64, in
    bf16: forward and prefill through mlstm_scan's wgmma route (CUDA)
    against the float32 plain version on the CPU.  bf16 rounds at other
    points on the two devices, so, as the Griffin slice holds its bf16
    model (ROADMAP C18), the kernel path's error may be at most twice the
    plain bf16 version's own."""
    _need_cuda()
    cfg = dataclasses.replace(get_arch("xlstm-1.3b").reduced(), n_heads=2,
                              dtype="bfloat16")
    assert 2 * cfg.d_model // cfg.n_heads == 64
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = R.init_params(cfg, 0, device="cpu")
    params32 = {k: ([{g: {n: w.float() for n, w in sub.items()}
                      for g, sub in lay.items()} for lay in v]
                    if k == "layers" else v.float())
                for k, v in params.items()}
    params_gpu = {k: ([{g: {n: w.cuda() for n, w in sub.items()}
                        for g, sub in lay.items()} for lay in v]
                      if k == "layers" else v.cuda())
                  for k, v in params.items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 150),
                         generator=torch.Generator().manual_seed(0))
    n_mlstm = cfg.n_layers // 2
    truth = R.forward_logits(params32, cfg32, {"tokens": toks}, device="cpu")
    plain = R.forward_logits(params, cfg, {"tokens": toks}, device="cpu")
    before = ml_kernel.LAUNCHES_BY_ROUTE["wgmma_bf16"]
    on = R.forward_logits(params_gpu, cfg, {"tokens": toks}, device="cuda")
    assert ml_kernel.LAUNCHES_BY_ROUTE["wgmma_bf16"] == before + n_mlstm
    plain_err = float((plain.float() - truth).abs().max())
    err = float((on.float().cpu() - truth).abs().max())
    assert plain_err < 0.15, plain_err
    assert err <= 2 * plain_err, (err, plain_err)
    lg_on, _ = R.prefill(params_gpu, cfg, {"tokens": toks[:, :140]},
                         device="cuda")
    lg_off, _ = R.prefill(params, cfg, {"tokens": toks[:, :140]},
                          device="cpu")
    assert ml_kernel.LAUNCHES_BY_ROUTE["wgmma_bf16"] == before + 2 * n_mlstm
    assert float((lg_on.float().cpu() - truth[:, 139]).abs().max()) <= \
        2 * max(plain_err, float((lg_off.float() - truth[:, 139]).abs().max()))


# --------------------------------------------------------------------------
# flash_attention's backward (csrc/flash_attention_bwd.cu; bf16 on
# ``wgmma_bf16``, float32 on ``scalar_f32``), through the wrapper's
# autograd function, against the plain backward's explicit formulas in
# float32 on the same q, k, v, o and dO.  bf16 rounds P and dS
# for the products that take them and dq, dk, dv on output, and reads the
# forward's bf16 o; float32 differs in summation order only.  Each
# gradient relative to its plain max |.|, floored at 1e-3 of the largest of
# the three: a smaller one is a sum of cancelling terms of that size.  Where
# every query sees one key (S 1, or a window of 1), dP = D, so dq = dk = 0
# in exact arithmetic and both sides hold rounding only: there dq and dk
# are held against the largest gradient's scale.
# --------------------------------------------------------------------------

BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _bwd_check(q, k, v, do, causal, window, grads, o):
    qd, kd, vd = (t.detach().float() for t in (q, k, v))
    lse = ref.reference_attention_lse(qd, kd, causal=causal, window=window)
    want = ref.reference_attention_bwd(qd, kd, vd, o.detach().float(), lse,
                                       do.float(), causal=causal,
                                       window=window)
    scales = [float(w.abs().max()) for w in want]
    floor = 1e-3 * max(scales)
    if q.shape[1] == 1 or window == 1:
        scales[0] = scales[1] = max(scales)
    for g, w, sc in zip(grads, want, scales):
        err = float((g.float() - w).abs().max())
        assert err <= BWD_TOL[q.dtype] * max(sc, floor), err


@pytest.mark.parametrize("B,S,H,KH,Dh,causal,window", [
    (1, 4096, 36, 36, 64, True, 0),     # minicpm-2b's training shape
    (1, 4096, 16, 1, 256, True, 2048),  # recurrentgemma's: MQA split
    (2, 1000, 8, 8, 64, True, 0),       # minicpm's head dim
    (2, 1000, 24, 8, 64, True, 0),      # granite's GQA
    (2, 65, 24, 8, 64, True, 0),        # granite's GQA, ragged
    (1, 1000, 8, 1, 256, True, 2048),   # recurrentgemma's MQA
    (2, 136, 4, 4, 128, True, 0),
    (2, 1000, 8, 2, 128, True, 100),    # a window that bites
    (2, 1, 8, 2, 64, True, 0),
    (2, 63, 8, 8, 120, True, 0),
    (2, 65, 6, 1, 256, True, 32),
    (2, 65, 4, 2, 16, True, 0),         # padded to 64 by the wrapper
    (2, 63, 4, 4, 80, False, 0),        # padded to 120
    (1, 200, 4, 2, 64, False, 40),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_matches_plain(B, S, H, KH, Dh, causal, window,
                                      dtype):
    _need_cuda()
    q, k, v = (t.requires_grad_() for t in _qkv(B, S, H, KH, Dh, dtype))
    do = _qkv(B, S, H, H, Dh, dtype, seed=1)[0]
    route = kernel.BWD_ROUTES[dtype]
    before = kernel.BWD_LAUNCHES_BY_ROUTE[route]
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert kernel.BWD_LAUNCHES_BY_ROUTE[route] == before + 1
    assert route == ("wgmma_bf16" if dtype == torch.bfloat16
                     else "scalar_f32")
    assert all(g.dtype == dtype and g.shape == t.shape
               for g, t in zip(grads, (q, k, v)))
    _bwd_check(q, k, v, do, causal, window, grads, o)


@pytest.mark.parametrize("B,S,H,KH,Dh,causal,window,splits", [
    (1, 4096, 16, 1, 256, True, 2048, None),   # split by the wrapper's rule
    (1, 1000, 16, 1, 256, True, 2048, 1),      # the same group unsplit
    (2, 300, 6, 1, 64, True, 0, 5),            # five shares of six heads
    (2, 65, 24, 8, 128, False, 0, 3),
])
def test_flash_backward_splits_agree_with_plain(B, S, H, KH, Dh, causal,
                                                window, splits):
    """The bf16 dK/dV pass with a KV head's query heads split over blocks
    (partials summed by the reduce pass) and unsplit."""
    _need_cuda()
    q, k, v = _qkv(B, S, H, KH, Dh, torch.bfloat16)
    do = _qkv(B, S, H, H, Dh, torch.bfloat16, seed=1)[0]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), device="cuda")
    scale = Dh ** -0.5
    kernel.launch(q, k, v, out, causal=causal, window=window, scale=scale,
                  lse=lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    kernel.launch_bwd(q, k, v, out, do, lse, torch.empty_like(lse), dq, dk,
                      dv, causal=causal, window=window, scale=scale,
                      splits=splits)
    torch.cuda.synchronize()
    _bwd_check(q, k, v, do, causal, window, (dq, dk, dv), out)


@pytest.mark.parametrize("B,S,H,KH,Dh,window", [
    (1, 4096, 16, 1, 256, 2048),    # MQA, heads split over blocks
    (2, 1000, 24, 8, 64, 0),        # GQA, unsplit
    (2, 63, 8, 8, 120, 0),
])
def test_flash_backward_is_deterministic(B, S, H, KH, Dh, window):
    """Two backward calls on the same inputs give the same bits: no
    atomics, and every sum in a fixed order."""
    _need_cuda()
    q, k, v = (t.requires_grad_() for t in _qkv(B, S, H, KH, Dh,
                                                 torch.bfloat16))
    do = _qkv(B, S, H, H, Dh, torch.bfloat16, seed=1)[0]
    o = ops.flash_attention(q, k, v, causal=True, window=window)
    first = torch.autograd.grad(o, (q, k, v), do, retain_graph=True)
    second = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_through_a_strided_q(dtype):
    """A transposed q (copied by the wrapper) reaches the same gradients."""
    _need_cuda()
    B, S, H, KH, Dh = 2, 130, 4, 2, 64
    q, k, v = _qkv(B, S, H, KH, Dh, dtype)
    qt = q.transpose(1, 2).contiguous().requires_grad_()   # (B, H, S, Dh)
    k.requires_grad_()
    v.requires_grad_()
    do = _qkv(B, S, H, H, Dh, dtype, seed=1)[0]
    o = ops.flash_attention(qt.transpose(1, 2), k, v, causal=True)
    dqt, dk, dv = torch.autograd.grad(o, (qt, k, v), do)
    _bwd_check(qt.transpose(1, 2), k, v, do, True, 0,
               (dqt.transpose(1, 2), dk, dv), o)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_forward_lse_matches_plain_and_leaves_output_unchanged(dtype):
    """The training forward's log-sum-exp; the output is the same bits
    with the lse pointer null (serving) and with it."""
    _need_cuda()
    for B, S, H, KH, Dh, window in ((2, 300, 8, 2, 64, 0),
                                    (1, 257, 4, 1, 256, 64),
                                    (2, 65, 4, 4, 120, 0)):
        q, k, v = _qkv(B, S, H, KH, Dh, dtype)
        o1, o2 = torch.empty_like(q), torch.empty_like(q)
        lse = torch.empty((B, H, S), device="cuda")
        kernel.launch(q, k, v, o1, causal=True, window=window)
        kernel.launch(q, k, v, o2, causal=True, window=window, lse=lse)
        torch.cuda.synchronize()
        assert torch.equal(o1, o2)
        want = ref.reference_attention_lse(q.float(), k.float(), causal=True,
                                           window=window)
        assert float((lse - want).abs().max()) <= 1e-4


def test_flash_serving_writes_no_lse():
    """Under no_grad (serving), or without an input that requires grad,
    the forward runs outside the autograd function."""
    _need_cuda()
    q, k, v = (t.requires_grad_() for t in _qkv(1, 64, 4, 4, 64,
                                                 torch.bfloat16))
    with torch.no_grad():
        o = ops.flash_attention(q, k, v)
    assert o.grad_fn is None
    o = ops.flash_attention(q.detach(), k.detach(), v.detach())
    assert o.grad_fn is None
    o = ops.flash_attention(q, k, v)
    assert o.grad_fn is not None


def test_kernels_without_a_backward_refuse_grad_on_cuda():
    """moe_gmm, the one kernel still without a backward, raises under grad
    rather than return an output with no gradient path, and runs under
    no_grad."""
    _need_cuda()
    xe, p = _gmm_inputs(4, 16, 64, 64, True, torch.bfloat16)
    calls = {"moe_gmm": lambda: gmm_ops.expert_ffn(xe, p, "swiglu")}
    for t in (xe, p["w1"]):
        t.requires_grad_()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward yet"):
            call()
        with torch.no_grad():
            call()
        with torch.inference_mode():
            call()
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# the recurrent kernels' backwards
# --------------------------------------------------------------------------

# rglru_scan's backward against the plain backward (explicit formulas in
# float32 on the same inputs and the forward's y), each gradient against
# the plain one's max |.| floored at 1e-3 of the largest: bf16 dx, dga, dgx
# are rounded on output (2**-9 of the value); float32 ones and the
# per-channel sums differ by summation order only.
RGLRU_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _grad_errs(got, want, floor_frac=1e-3):
    top = max(float(w.abs().max()) for w in want if w is not None)
    return [None if w is None else
            float((g.float() - w.float()).abs().max()) /
            max(float(w.abs().max()), floor_frac * top)
            for g, w in zip(got, want)]


def _rglru_grads(x, lam, ga, gx, h0, b_a, b_i, dy, dh_last):
    leaves = [None if t is None else t.detach().requires_grad_()
              for t in (x, lam, ga, gx, h0, b_a, b_i)]
    y, h_last = rg_ops.rglru(*leaves[:5], b_a=leaves[5], b_i=leaves[6])
    outs, cots = ([y, h_last], [dy, dh_last]) if dh_last is not None \
        else ([y], [dy])
    got = iter(torch.autograd.grad(outs, [t for t in leaves
                                          if t is not None], cots))
    return [None if t is None else next(got) for t in leaves], y.detach()


@pytest.mark.parametrize("B,S,D,with_h0,with_dhl,fused", [
    (1, 4096, 4096, False, False, True),   # recurrentgemma-9b train_4k
    (2, 1, 256, True, True, True),         # a single step
    (3, 63, 77, True, True, False),        # the 64-step chunk's edges
    (2, 64, 128, False, True, True),
    (2, 65, 200, True, False, True),
    (1, 129, 4100, True, True, True),      # D past whole 128-channel blocks
    (2, 1000, 512, True, True, False),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rglru_backward_matches_plain(B, S, D, with_h0, with_dhl, fused,
                                      dtype):
    _need_cuda()
    x, lam, ga, gx, h0, b_a, b_i = _scan_inputs(B, S, D, dtype, dtype,
                                                seed=S + D)
    h0 = h0 if with_h0 else None
    b_a, b_i = (b_a, b_i) if fused else (None, None)
    g = torch.Generator(device="cuda").manual_seed(7)
    dy = torch.randn((B, S, D), generator=g, device="cuda")
    dh_last = torch.randn((B, D), generator=g, device="cuda") \
        if with_dhl else None
    route = "fused_bias" if fused else "gates"
    before = rg_kernel.BWD_LAUNCHES_BY_ROUTE[route]
    got, y = _rglru_grads(x, lam, ga, gx, h0, b_a, b_i, dy, dh_last)
    torch.cuda.synchronize()
    assert rg_kernel.BWD_LAUNCHES_BY_ROUTE[route] == before + 1
    want = rg_ref.reference_rglru_bwd(x, lam, ga, gx, y, dy, h0, dh_last,
                                      b_a=b_a, b_i=b_i)
    for name, g_, w, e in zip(("dx", "dlam", "dga", "dgx", "dh0", "db_a",
                               "db_i"), got, want,
                              _grad_errs(got, want)):
        assert (g_ is None) == (w is None), name
        if w is None:
            continue
        assert g_.dtype == w.dtype, name
        tol = RGLRU_BWD_TOL[dtype] if name in ("dx", "dga", "dgx") else \
            RGLRU_BWD_TOL[torch.float32]
        assert e <= tol, (name, e)


def test_rglru_backward_long_memory_against_float64():
    """a from 0.999 to 0.9999 over 4096 steps: the kernel's gradients
    within twice the plain backward's own error against autograd of the
    recurrence in float64, or 1e-4."""
    _need_cuda()
    x, lam, ga, gx, h0, b_a, b_i = _scan_inputs(
        2, 4096, 512, torch.float32, torch.float32, u=(0.999, 0.9999))
    g = torch.Generator(device="cuda").manual_seed(8)
    dy = torch.randn((2, 4096, 512), generator=g, device="cuda")
    dh_last = torch.randn((2, 512), generator=g, device="cuda")
    got, y = _rglru_grads(x, lam, ga, gx, h0, b_a, b_i, dy, dh_last)
    plain = rg_ref.reference_rglru_bwd(x, lam, ga, gx, y, dy, h0, dh_last,
                                       b_a=b_a, b_i=b_i)
    leaves = [t.double().requires_grad_()
              for t in (x, lam, ga, gx, h0, b_a, b_i)]
    y64 = rg_ref.oracle_rglru(*leaves[:5], b_a=leaves[5], b_i=leaves[6])
    truth = torch.autograd.grad(
        (y64 * dy.double()).sum() + (y64[:, -1] * dh_last.double()).sum(),
        leaves)
    for e, pe in zip(_grad_errs(got, truth), _grad_errs(plain, truth)):
        assert e <= max(1e-4, 2 * pe)


def test_recurrent_kernels_serve_without_the_function():
    """Under no_grad, or without an input that requires grad, rglru_scan and
    mlstm_scan launch their forwards as serving does: no grad_fn, and
    mlstm_scan's forward writes no statistics (its h is the same with
    them)."""
    _need_cuda()
    x, lam, ga, gx, _, b_a, b_i = _scan_inputs(1, 70, 64, torch.bfloat16,
                                               torch.bfloat16)
    (q, k, v, ig, fg), _ = _mlstm_inputs(1, 70, 2, 64, torch.bfloat16)
    x.requires_grad_()
    q.requires_grad_()
    with torch.no_grad():
        y, _ = rg_ops.rglru(x, lam, ga, gx, b_a=b_a, b_i=b_i)
        h, _ = ml_ops.mlstm_chunkwise(q, k, v, ig, fg)
    assert y.grad_fn is None and h.grad_fn is None
    y2, _ = rg_ops.rglru(x, lam, ga, gx, b_a=b_a, b_i=b_i)
    h2, _ = ml_ops.mlstm_chunkwise(q, k, v, ig, fg)
    assert y2.grad_fn is not None and h2.grad_fn is not None
    assert torch.equal(y, y2.detach()) and torch.equal(h, h2.detach())


# mlstm_scan's backward against the plain backward (explicit formulas in
# float32, on the same inputs, the forward's h and its row statistics),
# each gradient against the plain one's max |.| floored at 1e-3 of the
# largest of dq, dk, dv (or of dig, dfg): bf16 dq, dk, dv are rounded on
# output; the rest differ by summation order only.
MLSTM_BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.mark.parametrize("B,S,H,Dh,with_init,clamp", [
    (1, 4096, 4, 1024, False, False),  # xlstm-1.3b's mLSTM at train_4k
    (2, 200, 4, 512, False, False),    # S not a multiple of either chunk
    (2, 1, 4, 256, False, False),      # a single step
    (1, 300, 4, 256, False, True),     # the denominator's floor on most rows
    (2, 136, 4, 512, True, False),     # a constant initial state
    (1, 100, 1, 1600, False, False),   # state slabs past shared memory
    (2, 150, 1, 37, True, False),      # bf16 forward on the scalar route
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mlstm_backward_matches_plain(B, S, H, Dh, with_init, clamp, dtype):
    _need_cuda()
    (q, k, v, ig, fg), init = _mlstm_inputs(B, S, H, Dh, dtype, with_init,
                                            seed=S + Dh)
    if clamp:
        ig = ig - 8.0
    g = torch.Generator(device="cuda").manual_seed(9)
    dh = torch.randn((B, S, H, Dh), generator=g, device="cuda")
    # the backward takes its forward's route: bf16 that TMA can address on
    # the wgmma route, Dh 37 on the scalar bf16 one
    route = ml_ops.kernel_route(q, k, v)
    assert route == ("scalar_f32" if dtype == torch.float32 else
                     "wgmma_bf16" if Dh % 8 == 0 else "scalar_bf16")
    before = ml_kernel.BWD_LAUNCHES_BY_ROUTE[route]
    leaves = [t.requires_grad_() for t in (q, k, v, ig, fg)]
    h, _ = ml_ops.mlstm_chunkwise(*leaves, init_state=init)
    m_t, den = h.grad_fn.saved_tensors[-2:]
    got = torch.autograd.grad(h, leaves, dh)
    torch.cuda.synchronize()
    assert ml_kernel.BWD_LAUNCHES_BY_ROUTE[route] == before + 1
    xs = [t.detach() for t in leaves]
    if clamp:
        assert float((den.abs() <= torch.exp(-m_t)).float().mean()) > 0.5
    want = ml_ref.reference_mlstm_bwd(*xs, h.detach(), (m_t, den), dh,
                                      init_state=init)
    errs = _grad_errs(got[:3], want[:3]) + _grad_errs(got[3:], want[3:])
    if S == 1:   # one key: dfg vanishes, and dq and dk where the floor
        top = max(float(w.abs().max()) for w in want[:3])   # is inactive
        errs[:2] = [float((g_.float() - w).abs().max()) / top
                    for g_, w in zip(got[:2], want[:2])]
        errs[4] = float((got[4] - want[4]).abs().max()) / max(
            float(w.abs().max()) for w in want[3:])
    tols = [MLSTM_BWD_TOL[dtype]] * 3 + [MLSTM_BWD_TOL[torch.float32]] * 2
    for name, g_, e, tol in zip(("dq", "dk", "dv", "dig", "dfg"), got, errs,
                                tols):
        assert g_.dtype == leaves[("dq", "dk", "dv", "dig",
                                   "dfg").index(name)].dtype
        assert e <= tol, (name, e)


def _mlstm_grads(xs, dh, init=None):
    """(h, the forward's row statistics (m_t, den_t), the gradients of q,
    k, v, ig and fg) through the autograd function."""
    leaves = [t.detach().requires_grad_() for t in xs]
    h, _ = ml_ops.mlstm_chunkwise(*leaves, init_state=init)
    stats = h.grad_fn.saved_tensors[-2:]
    return h, stats, torch.autograd.grad(h, leaves, dh)


def test_mlstm_backward_of_a_misaligned_bf16_view_takes_scalar_bf16():
    """bf16 q, k, v off TMA's 16-byte boundaries (contiguous views of a
    buffer one element in) take the scalar bf16 route forwards and
    backwards, and agree with the plain backward."""
    _need_cuda()
    B, S, H, Dh = 2, 150, 2, 64
    (q, k, v, ig, fg), _ = _mlstm_inputs(B, S, H, Dh, torch.bfloat16,
                                         seed=21)
    views = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        view = buf[1:].view(t.shape)
        view.copy_(t)
        views.append(view)
    assert all(t.data_ptr() % 16 for t in views)
    assert ml_ops.kernel_route(*views) == "scalar_bf16"
    g = torch.Generator(device="cuda").manual_seed(9)
    dh = torch.randn((B, S, H, Dh), generator=g, device="cuda")
    before = dict(ml_kernel.BWD_LAUNCHES_BY_ROUTE)
    h, (m_t, den), got = _mlstm_grads(views + [ig, fg], dh)
    torch.cuda.synchronize()
    assert ml_kernel.BWD_LAUNCHES_BY_ROUTE["scalar_bf16"] == \
        before["scalar_bf16"] + 1
    assert ml_kernel.BWD_LAUNCHES_BY_ROUTE["wgmma_bf16"] == \
        before["wgmma_bf16"]
    want = ml_ref.reference_mlstm_bwd(*views, ig, fg, h.detach(), (m_t, den),
                                      dh)
    errs = _grad_errs(got[:3], want[:3]) + _grad_errs(got[3:], want[3:])
    tols = [MLSTM_BWD_TOL[torch.bfloat16]] * 3 + \
        [MLSTM_BWD_TOL[torch.float32]] * 2
    assert all(e <= t for e, t in zip(errs, tols)), errs


@pytest.mark.parametrize("B,S,H,Dh,with_init", [
    (1, 4096, 4, 1024, False),   # xlstm-1.3b's mLSTM at train_4k
    (2, 200, 2, 192, True),
])
def test_mlstm_backward_repeats_bit_for_bit(B, S, H, Dh, with_init):
    """The wgmma route sums every part in a fixed order (no atomics): two
    calls on the same inputs give the same dq, dk, dv and dig, bit for
    bit."""
    _need_cuda()
    (q, k, v, ig, fg), init = _mlstm_inputs(B, S, H, Dh, torch.bfloat16,
                                            with_init, seed=22)
    assert ml_ops.kernel_route(q, k, v) == "wgmma_bf16"
    g = torch.Generator(device="cuda").manual_seed(9)
    dh = torch.randn((B, S, H, Dh), generator=g, device="cuda")
    first = _mlstm_grads((q, k, v, ig, fg), dh, init)[2]
    second = _mlstm_grads((q, k, v, ig, fg), dh, init)[2]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dig"), first, second):
        assert torch.equal(a, b), name


def test_mlstm_backward_copies_a_misaligned_dh():
    """The wgmma route reads dh by TMA-aligned 16-byte loads: a dh off a
    16-byte boundary (a contiguous view one float into a buffer) is copied
    by the autograd function, and gives the aligned dh's gradients bit for
    bit."""
    _need_cuda()
    B, S, H, Dh = 2, 200, 2, 64
    (q, k, v, ig, fg), _ = _mlstm_inputs(B, S, H, Dh, torch.bfloat16,
                                         seed=23)
    g = torch.Generator(device="cuda").manual_seed(9)
    dh = torch.randn((B, S, H, Dh), generator=g, device="cuda")
    buf = torch.empty(dh.numel() + 1, device="cuda")
    off = buf[1:].view(dh.shape)
    off.copy_(dh)
    assert off.data_ptr() % 16 and off.is_contiguous()
    want = _mlstm_grads((q, k, v, ig, fg), dh)[2]
    got = _mlstm_grads((q, k, v, ig, fg), off)[2]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dig", "dfg"), got, want):
        assert torch.equal(a, b), name


def test_mlstm_forward_chain_meets_the_last_rows_stabiliser():
    """The wgmma backward scales its states by the chain of m of the
    forward's state pass, which its output pass also used for each row's
    m_t: at a chunk's last row the two are one float expression, so the
    final m (the chain's) equals the last row's m_t bit for bit, at S a
    multiple of the chunk and ragged, with and without an initial state."""
    _need_cuda()
    for S, with_init in ((256, False), (200, True), (1, False), (4096, True)):
        (q, k, v, ig, fg), init = _mlstm_inputs(2, S, 2, 64, torch.bfloat16,
                                                with_init, seed=S)
        h, (C, n, m), (m_t, den) = ml_ops._forward(
            q, k, v, ig, fg, init, "wgmma_bf16", True)
        torch.cuda.synchronize()
        assert torch.equal(m, m_t[:, -1]), S


@pytest.mark.parametrize("S,Dh,dtype", [
    (1000, 1024, torch.bfloat16),   # the wgmma route, chunks of 128
    (300, 96, torch.bfloat16),
    (200, 512, torch.float32),      # the scalar routes, chunks of 64
    (150, 37, torch.bfloat16),
])
def test_mlstm_forward_writes_its_row_statistics(S, Dh, dtype):
    """The training forward's m_t and den_t against the plain ones, and its
    h bit for bit the serving forward's."""
    _need_cuda()
    (q, k, v, ig, fg), init = _mlstm_inputs(2, S, 2, Dh, dtype, True)
    route = ml_ops.kernel_route(q, k, v)
    outs = []
    for with_stats in (False, True):
        outs.append(ml_ops._forward(q, k, v, ig, fg, init, route,
                                    with_stats))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0])
    m_t, den = outs[1][2]
    pm, pden, _ = ml_ref.reference_mlstm_stats(q, k, v, ig, fg,
                                               init_state=init)
    assert float((m_t - pm).abs().max()) <= 1e-4 * max(
        float(pm.abs().max()), 1.0)
    assert float((den - pden).abs().max()) <= 1e-4 * float(
        pden.abs().max())
