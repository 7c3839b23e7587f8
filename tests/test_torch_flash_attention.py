"""The port's flash-attention wrapper on the CPU, against the JAX package's
Pallas kernel in interpret mode (and its reference fallback), plus the
wrapper's checks and the build's error path.  The CUDA kernel itself is
held against the plain version on the card (tests/test_torch_kernels_gpu.py).
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jax_ops
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel, ops

# float32 on both sides: the online softmax of the Pallas kernel against the
# exact softmax of the port's plain version
F32 = dict(rtol=1e-5, atol=1e-5)


def _qkv(B, S, H, KH, Dh, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, h, Dh)).astype(np.float32)
                 for h in (H, KH, KH))


@pytest.mark.parametrize("S,window", [
    (256, 128),     # tiles: the JAX side runs the Pallas kernel (interpret)
    (200, 0),       # does not tile: the JAX side falls back to its reference
])
def test_cpu_wrapper_matches_jax_kernel(S, window):
    q, k, v = _qkv(1, S, 4, 2, 64)
    want = np.asarray(jax_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, interpret=True))
    before = kernel.LAUNCHES
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window)
    assert kernel.LAUNCHES == before        # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("window", [128, 0])
def test_cpu_wrapper_matches_jax_kernel_at_griffins_head_dim(window):
    """recurrentgemma's LOCAL layers: MQA (one KV head for 4 query heads)
    at head dim 256, which the CUDA kernel now takes too."""
    assert 256 in ops.SUPPORTED_HEAD_DIMS
    q, k, v = _qkv(1, 256, 4, 1, 256, seed=1)
    want = np.asarray(jax_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, interpret=True))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("shapes,msg", [
    (((1, 8, 4, 64), (1, 8, 3, 64), (1, 8, 3, 64)), "do not group"),
    (((1, 8, 4, 64), (1, 9, 2, 64), (1, 9, 2, 64)), "do not match"),
    (((1, 8, 4, 64), (1, 8, 2, 64), (1, 8, 2, 32)), "do not match"),
    (((8, 4, 64), (8, 2, 64), (8, 2, 64)), r"\(B, S, heads, Dh\)"),
])
def test_wrapper_rejects_bad_shapes(shapes, msg):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=msg):
        ops.flash_attention(q, k, v)


def test_wrapper_rejects_negative_window():
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=-1)


def test_non_cpu_tensor_goes_to_the_kernel_checks_never_the_plain_path():
    q = torch.zeros(1, 8, 2, 64, device="meta")
    before = kernel.LAUNCHES
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.flash_attention(torch.zeros(1, 8, 2, 64), q, q)
    assert kernel.LAUNCHES == before


def test_kernel_source_instantiates_the_supported_head_dims():
    src = (build.KERNELS_DIR / "flash_attention" / "csrc" /
           "flash_attention.cu").read_text()
    cases = sorted({int(c) for c in re.findall(r"case (\d+):", src)})
    assert tuple(cases) == ops.SUPPORTED_HEAD_DIMS


def test_build_sources_are_every_csrc_file():
    names = [p.name for p in build.sources()]
    assert {"flash_attention.cu", "cuda_errors.cu", "moe_gmm.cu",
            "rglru_scan.cu"} <= set(names)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
