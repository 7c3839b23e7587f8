"""Public RG-LRU wrapper, with the contract of the JAX package's
``models.rglru.rglru``: x, ga, gx (B, S, D); lam (D,); h0 (B, D) or None.
Returns (y (B, S, D) float32, h_last (B, D) float32).

With the gate biases ``b_a`` and ``b_i`` (float32 (D,), both or neither),
ga and gx are the bias-free gate products and the gates are ``ga + b_a``
and ``gx + b_i`` in float32, as PyTorch promotes a bf16 product and a
float32 bias: the kernel adds them itself (route ``fused_bias``), so that
a bf16 model hands its gates over in bf16.

On tensors that lie on the CPU it computes the plain version (``ref``).  On
CUDA tensors it launches the CUDA kernel or raises: there is no fallback,
for any shape, for ``h0`` or for a build failure.

Under grad mode, with an input that requires grad, the kernel runs inside
``RGLRUScanFunction``: the forward saves its output y (the h_t, float32),
and the backward is the hand-written kernel of ``csrc/rglru_scan_bwd.cu``.
Otherwise (serving, under ``no_grad`` or ``inference_mode``) the forward
launches as it is.

On ``meta`` tensors it computes nothing and returns empty outputs of the
right shapes.  Under a ``distributed.flops.FlopCounter`` each call, and
each backward, counts by ``cost.work`` and ``cost.bwd_work`` on every
device.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.distributed import flops
from repro_torch.kernels.rglru_scan import cost, kernel, ref

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(x, lam, ga, gx, h0, b_a, b_i) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, D), got {tuple(x.shape)}")
    B, S, D = x.shape
    if ga.shape != x.shape or gx.shape != x.shape:
        raise ValueError(f"ga {tuple(ga.shape)} and gx {tuple(gx.shape)} do "
                         f"not match x {tuple(x.shape)}")
    if tuple(lam.shape) != (D,):
        raise ValueError(f"lam {tuple(lam.shape)} is not ({D},)")
    if h0 is not None and tuple(h0.shape) != (B, D):
        raise ValueError(f"h0 {tuple(h0.shape)} is not {(B, D)}")
    if (b_a is None) != (b_i is None):
        raise ValueError("give both gate biases b_a and b_i, or neither")
    for name, bias in (("b_a", b_a), ("b_i", b_i)):
        if bias is None:
            continue
        if tuple(bias.shape) != (D,):
            raise ValueError(f"{name} {tuple(bias.shape)} is not ({D},)")
        if bias.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {bias.dtype}")
    if min(B, S, D) == 0:
        raise ValueError(f"empty RG-LRU input {tuple(x.shape)}")


def check_kernel_args(x, lam, ga, gx, h0, b_a, b_i) -> None:
    """Raise on anything the CUDA kernel does not take."""
    ts = [t for t in (x, lam, ga, gx, h0, b_a, b_i) if t is not None]
    devices = {t.device for t in ts}
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"the kernel takes x, lam, ga, gx, h0, b_a and b_i "
                         f"on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if x.dtype not in SUPPORTED_DTYPES or ga.dtype not in SUPPORTED_DTYPES \
            or gx.dtype != ga.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 x, and "
                         f"float32 or bfloat16 ga and gx of one dtype, got "
                         f"{x.dtype}, {ga.dtype}, {gx.dtype}")
    if lam.dtype != torch.float32 or (h0 is not None and
                                      h0.dtype != torch.float32):
        raise ValueError("the kernel takes float32 lam and h0")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the kernel takes contiguous x, lam, ga, gx, h0, "
                         "b_a and b_i")


def _forward(x, lam, ga, gx, h0, b_a, b_i):
    B, S, D = x.shape
    y = torch.empty((B, S, D), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, D), dtype=torch.float32, device=x.device)
    kernel.launch(x, lam, ga, gx, b_a, b_i, h0, y, h_last)
    return y, h_last


class RGLRUScanFunction(torch.autograd.Function):
    """The kernel's forward and backward on checked inputs
    (``check_kernel_args``); returns (y, h_last)."""

    @staticmethod
    def forward(ctx, x, lam, ga, gx, h0, b_a, b_i):
        y, h_last = _forward(x, lam, ga, gx, h0, b_a, b_i)
        ctx.save_for_backward(x, lam, ga, gx, h0, b_a, b_i, y)
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_last):
        x, lam, ga, gx, h0, b_a, b_i, y = ctx.saved_tensors
        with flops.recorded("rglru_scan_bwd", lambda: cost.bwd_work(
                *x.shape, x.dtype, b_a is not None)):
            dy = torch.zeros_like(y) if dy is None else \
                dy.float().contiguous()
            if dh_last is not None:
                dh_last = dh_last.float().contiguous()
            f32 = dict(dtype=torch.float32, device=x.device)
            dx, dga, dgx = (torch.empty_like(t) for t in (x, ga, gx))
            dlam = torch.empty(lam.shape, **f32)
            db_a, db_i = (None, None) if b_a is None else \
                (torch.empty(b_a.shape, **f32),
                 torch.empty(b_i.shape, **f32))
            dh0 = None if h0 is None else torch.empty(h0.shape, **f32)
            kernel.launch_bwd(x, lam, ga, gx, b_a, b_i, h0, y, dy, dh_last,
                              dx, dga, dgx, dlam, db_a, db_i, dh0)
        return dx, dlam, dga, dgx, dh0, db_a, db_i


def rglru(x, lam, ga, gx, h0=None, *, b_a=None, b_i=None):
    """RG-LRU gates and recurrence; see ``ref.reference_rglru``."""
    _check_shapes(x, lam, ga, gx, h0, b_a, b_i)
    ts = (x, lam, ga, gx, h0, b_a, b_i)
    fused = b_a is not None
    shape = (*x.shape, x.dtype)

    def work():
        return cost.work(*shape, ga.dtype, h0 is not None, fused)

    def bwd_work():
        return cost.bwd_work(*shape, fused)
    devices = {t.device.type for t in ts if t is not None}
    if devices == {"meta"} or (devices == {"cpu"} and flops.counting()):
        def plain(x, lam, ga, gx, h0, b_a, b_i):
            if "meta" in devices:
                B, _, D = x.shape
                return (torch.empty(x.shape, dtype=torch.float32,
                                    device=x.device),
                        torch.empty((B, D), dtype=torch.float32,
                                    device=x.device))
            return ref.reference_rglru(x, lam, ga, gx, h0, b_a=b_a,
                                       b_i=b_i)
        return flops.counted_call("rglru_scan", work, bwd_work, plain, ts,
                                  meta="meta" in devices)
    if devices == {"cpu"}:
        return ref.reference_rglru(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
    with flops.recorded("rglru_scan", work):
        # lam and h0 are read in float32, as the reference casts them
        lam = lam.float()
        h0 = None if h0 is None else h0.float()
        check_kernel_args(x, lam, ga, gx, h0, b_a, b_i)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in ts):
            return RGLRUScanFunction.apply(x, lam, ga, gx, h0, b_a, b_i)
        return _forward(x, lam, ga, gx, h0, b_a, b_i)
