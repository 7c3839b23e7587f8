"""The port's flash-attention wrapper on the CPU, against the JAX package's
Pallas kernel in interpret mode (and its reference fallback), plus the
wrapper's checks and the build's error path.  The CUDA kernel itself is
held against the plain version on the card (tests/test_torch_kernels_gpu.py).
"""
import contextlib
import re
import types

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
    """Each supported head dim has a case in the dispatch, which launches the
    wgmma route for bf16 and the scalar route for float32."""
    src = (build.KERNELS_DIR / "flash_attention" / "csrc" /
           "flash_attention.cu").read_text()
    cases = sorted({int(c) for c in re.findall(r"case (\d+):", src)})
    assert tuple(cases) == ops.SUPPORTED_HEAD_DIMS
    dispatch = src[src.index('extern "C" int repro_flash_attention_fwd'):]
    for dh in ops.SUPPORTED_HEAD_DIMS:
        case = re.search(rf"case {dh}:(.*?)(?=case |default:)", dispatch,
                         re.S).group(1)
        assert re.search(rf"bf16 \? launch_bf16<{dh}>\(.*: launch_f32<{dh}>\(",
                         case, re.S), case
    assert kernel.ROUTES == {torch.bfloat16: (1, "wgmma_bf16"),
                             torch.float32: (0, "scalar_f32")}


def test_bf16_alignment_check_needs_16_byte_boundaries():
    """TMA addresses the bf16 route's tensors only from 16-byte boundaries;
    the check raises on a view one element into its storage, and the scalar
    float32 route takes such a view."""
    shape = (1, 8, 2, 64)
    storage = torch.zeros(int(np.prod(shape)) + 8, dtype=torch.bfloat16)
    aligned = storage[:-8].view(shape)
    assert aligned.data_ptr() % 16 == 0
    misaligned = storage[1:-7].view(shape)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 == 2
    ops.check_alignment(aligned, aligned, aligned)
    for args in ((misaligned, aligned, aligned), (aligned, aligned,
                                                  misaligned)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            ops.check_alignment(*args)
    f32 = torch.zeros(int(np.prod(shape)) + 1)[1:].view(shape)
    assert f32.data_ptr() % 16 == 4
    ops.check_alignment(f32, f32, f32)


@pytest.mark.parametrize("head_dim,padded", [
    (16, 64), (64, 64), (80, 120), (96, 120), (120, 120), (121, 128),
    (130, 256), (256, 256)])
def test_kernel_layout_pads_the_head_dim_to_a_supported_one(head_dim,
                                                            padded):
    """The kernel is built for SUPPORTED_HEAD_DIMS; any other head dim up
    to 256 is zero-padded to the next of them, and the padded q k^T and
    the first head_dim columns of the padded P V are the unpadded ones."""
    assert ops.kernel_head_dim(head_dim) == padded
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 4, 2, head_dim))
    pq, pk, pv = ops.kernel_layout(q, k, v)
    for t, p in ((q, pq), (k, pk), (v, pv)):
        assert p.shape == t.shape[:3] + (padded,) and p.is_contiguous()
        assert torch.equal(p[..., :head_dim], t)
        assert not p[..., head_dim:].any()
        assert (p is t) == (padded == head_dim)
    kk = k.repeat_interleave(2, dim=2)
    pkk = pk.repeat_interleave(2, dim=2)
    torch.testing.assert_close(torch.einsum("bqhd,bkhd->bhqk", pq, pkk),
                               torch.einsum("bqhd,bkhd->bhqk", q, kk))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_layout_copies_only_what_the_kernel_cannot_address(dtype):
    """A transposed view and a slice of a fused QKV tensor are copied to
    fresh contiguous tensors; a contiguous view off a 16-byte boundary is
    copied in bf16 (TMA) and passed as it is in float32 (the scalar
    route); a contiguous aligned tensor is passed as it is."""
    B, S, H, Dh = 1, 8, 2, 64
    n = B * S * H * Dh
    fresh = torch.randn(B, S, H, Dh).to(dtype)
    transposed = torch.randn(B, H, S, Dh).to(dtype).transpose(1, 2)
    fused = torch.randn(B, S, 3 * H, Dh).to(dtype)[:, :, :H]
    storage = torch.randn(n + 8).to(dtype)
    misaligned = storage[1:n + 1].view(B, S, H, Dh)
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16
    out = ops.kernel_layout(transposed, fused, misaligned)
    for src, got in zip((transposed, fused, misaligned), out):
        assert got.is_contiguous() and torch.equal(got, src)
    assert out[0] is not transposed and out[1] is not fused
    assert (out[2] is misaligned) == (dtype == torch.float32)
    if dtype == torch.bfloat16:
        assert out[2].data_ptr() % 16 == 0
    q, k, v = ops.kernel_layout(fresh, fresh, fresh)
    assert q is fresh and k is fresh and v is fresh


def test_launch_counts_each_dtype_on_its_route(monkeypatch):
    """``kernel.launch`` hands the C function its route's dtype code and
    counts the launch under that route; a stand-in takes the C function's
    place, so nothing is launched."""
    calls = []

    def fake_fwd(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(kernel, "_kernel_fn", lambda: fake_fwd)
    monkeypatch.setattr(kernel.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(kernel.torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kernel, "LAUNCHES", 5)
    monkeypatch.setattr(kernel, "LAUNCHES_BY_ROUTE",
                        {"wgmma_bf16": 2, "scalar_f32": 3})
    for dtype, n in ((torch.bfloat16, 2), (torch.float32, 1)):
        q = torch.zeros(1, 8, 4, 64, dtype=dtype)
        kv = torch.zeros(1, 8, 2, 64, dtype=dtype)
        for _ in range(n):
            kernel.launch(q, kv, kv, torch.empty_like(q), causal=True,
                          window=16)
    assert [c[12] for c in calls] == [1, 1, 0]    # the dtype code
    assert [c[4] for c in calls] == [None] * 3     # no log-sum-exp asked
    assert [c[5:12] for c in calls] == [(1, 8, 4, 2, 64, 1, 16)] * 3
    assert kernel.LAUNCHES == 8
    assert kernel.LAUNCHES_BY_ROUTE == {"wgmma_bf16": 4, "scalar_f32": 4}
    kernel.reset_launches()
    assert kernel.LAUNCHES == 0
    assert kernel.LAUNCHES_BY_ROUTE == {"wgmma_bf16": 0, "scalar_f32": 0}


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
