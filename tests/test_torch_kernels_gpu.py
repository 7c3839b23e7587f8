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
from repro_torch.models import registry as R

pytestmark = pytest.mark.gpu

# kernel output rounded to bf16 vs a float32 plain version on the same
# inputs: half an ulp of |o| < 8 is <= 7.8e-3.  float32 vs float32 (no
# TF32): summation order only.
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


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


def test_flash_kernel_rejects_what_it_does_not_take():
    _need_cuda()
    q, k, v = _qkv(1, 16, 2, 2, 96, torch.float32)
    with pytest.raises(ValueError, match="head dim 96"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 16, 2, 2, 64, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(1, 16, 2, 2, 64, torch.float32)
    q_strided = torch.randn((1, 2, 16, 64), device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q_strided, k, v)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention(q, k.cpu(), v)


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
