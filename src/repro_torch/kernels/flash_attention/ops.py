"""Public flash-attention wrapper, with the contract of the JAX package's
``ops.flash_attention``: q (B, S, H, Dh), k and v (B, S, KH, Dh).

On tensors that lie on the CPU it computes the plain version (``ref``).  On
CUDA tensors it launches the CUDA kernel or raises: there is no fallback,
and any sequence length runs on the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref

SUPPORTED_HEAD_DIMS = (64, 120, 128)
SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_MAX_BATCH_HEADS = 65535    # the kernel's grid.y


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


def check_kernel_args(q, k, v) -> None:
    """Raise on anything the CUDA kernel does not take."""
    devices = {t.device for t in (q, k, v)}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"the kernel takes q, k, v on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not supported by the kernel "
                         f"(supported: {SUPPORTED_HEAD_DIMS})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q, k, v")
    if q.shape[0] * q.shape[2] > _MAX_BATCH_HEADS:
        raise ValueError(f"B * H = {q.shape[0] * q.shape[2]} exceeds "
                         f"{_MAX_BATCH_HEADS}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, S, H, Dh); k, v: (B, S, KH, Dh) -> (B, S, H, Dh)."""
    _check_shapes(q, k, v, window)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.reference_attention(q, k, v, causal=causal, window=window)
    check_kernel_args(q, k, v)
    out = torch.empty_like(q)
    kernel.launch(q, k, v, out, causal=causal, window=window)
    return out
