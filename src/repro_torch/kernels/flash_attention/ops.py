"""Public flash-attention wrapper, with the contract of the JAX package's
``ops.flash_attention``: q (B, S, H, Dh), k and v (B, S, KH, Dh).

On tensors that lie on the CPU it computes the plain version (``ref``).  On
CUDA tensors it launches the CUDA kernel or raises: there is no fallback,
and any sequence length, any head dim up to 256 and any layout run on the
kernel.  The kernel's route follows the dtype: bf16 runs on tensor cores
(``wgmma`` on tiles that TMA loads, which needs 16-byte aligned tensors),
float32 on scalar FMAs.  The kernel is built for the head dims in
``SUPPORTED_HEAD_DIMS``; ``kernel_layout`` hands it any other q, k, v
zero-padded along Dh to the next of them (zeros add nothing to q k^T, and
the padded columns of the output are dropped; the scale stays that of the
true Dh), and copies a non-contiguous q, k or v, or a bf16 one off a
16-byte boundary, into a fresh contiguous tensor.

Under grad mode, with an input that requires grad, the kernel runs inside
``FlashAttentionFunction``: the forward also writes each row's
log-sum-exp, and the backward is the hand-written kernel of
``csrc/flash_attention_bwd.cu``.  ``kernel_layout``'s padding and copies
stay outside the function, so autograd carries the gradient through them
(and drops a padded head dim's extra columns).  Otherwise (serving, under
``no_grad`` or ``inference_mode``) the forward writes no log-sum-exp.

On ``meta`` tensors it computes nothing and returns an empty output of the
right shape.  Under a ``distributed.flops.FlopCounter`` each call, and
each backward, counts by ``cost.work`` and ``cost.bwd_work`` on every
device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.distributed import flops
from repro_torch.kernels.flash_attention import cost, kernel, ref

SUPPORTED_HEAD_DIMS = (64, 120, 128, 256)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_MAX_BATCH_HEADS = 65535    # the scalar kernel's grid.y


def _check_shapes(q, k, v, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, Dh)")
    B, S, H, Dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != Dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over "
                         f"{k.shape[2]} KV heads")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def check_alignment(q, k, v) -> None:
    """Raise on bf16 q, k, v that TMA cannot address: their data must start
    on a 16-byte boundary.  The float32 route has no such need."""
    offsets = [t.data_ptr() % 16 for t in (q, k, v)]
    if q.dtype == torch.bfloat16 and any(offsets):
        raise ValueError(f"the bf16 kernel takes q, k, v whose data start on "
                         f"a 16-byte boundary, got offsets {offsets}")


def check_kernel_args(q, k, v) -> None:
    """Raise on anything the CUDA kernel does not take, in any layout."""
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"the kernel takes q, k, v on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] > SUPPORTED_HEAD_DIMS[-1]:
        raise ValueError(f"head dim {q.shape[3]} exceeds the kernel's "
                         f"largest, {SUPPORTED_HEAD_DIMS[-1]}")
    if q.shape[0] * q.shape[2] > _MAX_BATCH_HEADS:
        raise ValueError(f"B * H = {q.shape[0] * q.shape[2]} exceeds "
                         f"{_MAX_BATCH_HEADS}")


def kernel_head_dim(head_dim: int) -> int:
    """The supported head dim a head dim of at most 256 is padded to."""
    return next(dh for dh in SUPPORTED_HEAD_DIMS if dh >= head_dim)


def kernel_layout(q, k, v):
    """q, k, v as the kernel takes them: contiguous, bf16 on 16-byte
    boundaries (``check_alignment``), their head dim zero-padded to
    ``kernel_head_dim``.  A tensor that is so already is passed as it is;
    any other is a fresh copy."""
    dh = kernel_head_dim(q.shape[3])

    def fit(t):
        if t.shape[3] != dh:
            return F.pad(t, (0, dh - t.shape[3]))
        if not t.is_contiguous() or \
                (t.dtype == torch.bfloat16 and t.data_ptr() % 16):
            return t.clone(memory_format=torch.contiguous_format)
        return t
    return fit(q), fit(k), fit(v)


def _forward(q, k, v, causal, window, scale, with_lse):
    out = torch.empty_like(q)
    lse = None
    if with_lse:
        B, S, H, _ = q.shape
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    kernel.launch(q, k, v, out, causal=causal, window=window, scale=scale,
                  lse=lse)
    return out, lse


class FlashAttentionFunction(torch.autograd.Function):
    """The kernel's forward and backward on q, k, v in the kernel's layout
    (``kernel_layout``); ``scale`` multiplies the scores."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, scale: float):
        out, lse = _forward(q, k, v, causal, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        B, S, H, _ = q.shape
        # the head dim before padding, whose 1/sqrt the wrapper passed
        head_dim = round(ctx.scale ** -2)
        with flops.recorded("flash_attention_bwd", lambda: cost.bwd_work(
                B, S, H, k.shape[2], head_dim, ctx.causal, ctx.window,
                q.dtype)):
            dout = dout.to(q.dtype).contiguous()
            if dout.dtype == torch.bfloat16 and dout.data_ptr() % 16:
                dout = dout.clone()
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            kernel.launch_bwd(q, k, v, out, dout, lse, torch.empty_like(lse),
                              dq, dk, dv, causal=ctx.causal,
                              window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, Dh); k, v: (B, S, KH, Dh) -> (B, S, H, Dh)."""
    _check_shapes(q, k, v, window)
    B, S, H, head_dim = q.shape
    shape = (B, S, H, k.shape[2], head_dim, causal, window, q.dtype)
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"meta"} or (devices == {"cpu"} and flops.counting()):
        def plain(q, k, v):
            if "meta" in devices:
                return (torch.empty(q.shape, dtype=q.dtype, device=q.device),)
            return (ref.reference_attention(q, k, v, causal=causal,
                                            window=window),)
        return flops.counted_call(
            "flash_attention", lambda: cost.work(*shape),
            lambda: cost.bwd_work(*shape), plain, (q, k, v),
            meta="meta" in devices)[0]
    if devices == {"cpu"}:
        return ref.reference_attention(q, k, v, causal=causal, window=window)
    with flops.recorded("flash_attention", lambda: cost.work(*shape)):
        check_kernel_args(q, k, v)
        scale = 1.0 / math.sqrt(head_dim)
        q, k, v = kernel_layout(q, k, v)
        check_alignment(q, k, v)
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            out = FlashAttentionFunction.apply(q, k, v, causal, window,
                                               scale)
        else:
            out, _ = _forward(q, k, v, causal, window, scale, with_lse=False)
        return out if head_dim == out.shape[3] else \
            out[..., :head_dim].contiguous()
