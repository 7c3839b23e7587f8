"""Public grouped expert-FFN wrapper, with the contract of the JAX package's
``ops.expert_ffn``: xe (E, C, d); p = {w1: (E, d, f), w3: (E, d, f) or
absent, w2: (E, f, d)}; the weights are cast to ``xe.dtype``.  ``counts``,
an optional int32 (E,) tensor, gives each bucket's fill: the rows at or
past ``counts[e]`` are pads, and their y is exactly 0 (what the function
gives a zero pad row).  Without it every row is live.

On tensors that lie on the CPU it computes the plain version (``ref``).  On
CUDA tensors it launches the CUDA kernels or raises: there is no fallback,
and any C, d and f run on the kernels.  The route is chosen by dtype,
shape and alignment (``kernel_route``), before any launch, never by
catching an error:
* float32 takes ``scalar_f32``, scalar FMAs;
* bf16 that TMA can address takes ``wgmma_bf16``: d and f multiples of 8
  (TMA's strides are multiples of 16 bytes) and xe and the weights on
  16-byte boundaries;
* other bf16 takes ``wmma_bf16``, WMMA fragments on plain loads.

Under grad mode, with an input that requires grad, the kernel runs inside
``ExpertFFNFunction``, whose backward on CUDA tensors is the CUDA kernel of
``csrc/moe_gmm_bwd.cu`` (``expert_ffn_bwd``) on the forward's route, over
each bucket's live rows with a1 and a3 recomputed, as the JAX package
differentiates its plain einsums (its Pallas kernel has no gradient); on
CPU tensors it is the plain version, ``ref.reference_expert_ffn_bwd``.
The weights are cast to ``xe.dtype`` outside the function, so autograd
carries their gradient back to float32 master weights.
Otherwise (serving, under ``no_grad`` or ``inference_mode``) the kernel
runs on its own.

On ``meta`` tensors it computes nothing and returns an empty output of the
right shape.  Under a ``distributed.flops.FlopCounter`` each call, and
each backward, counts by ``cost.work`` and ``cost.bwd_work`` on every
device, over all E * C rows of the buckets: how many of them are live is
data, which ``meta`` does not have, so the count takes the rows the
capacity fixes (the kernel skips the pads on the card).
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.distributed import flops
from repro_torch.kernels.moe_gmm import cost, kernel, ref

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
_MAX_EXPERTS = 65535    # the scalar and WMMA kernels' grid.z
_MAX_ROWS = 65535 * 64  # their grid.y of 64-row tiles


def _check_shapes(xe, p, act: str, counts) -> None:
    if act not in kernel.ACT_CODE:
        raise ValueError(f"unknown act {act!r}; known: "
                         f"{sorted(kernel.ACT_CODE)}")
    if xe.dim() != 3:
        raise ValueError(f"xe must be (E, C, d), got {tuple(xe.shape)}")
    E, _, d = xe.shape
    w1, w2, w3 = p["w1"], p["w2"], p.get("w3")
    if w1.dim() != 3 or tuple(w1.shape[:2]) != (E, d):
        raise ValueError(f"w1 {tuple(w1.shape)} is not (E, d, f) for xe "
                         f"{tuple(xe.shape)}")
    f = w1.shape[2]
    if tuple(w2.shape) != (E, f, d):
        raise ValueError(f"w2 {tuple(w2.shape)} is not (E, f, d) = "
                         f"{(E, f, d)}")
    if w3 is not None and w3.shape != w1.shape:
        raise ValueError(f"w3 {tuple(w3.shape)} does not match w1 "
                         f"{tuple(w1.shape)}")
    if counts is not None and (tuple(counts.shape) != (E,) or
                               counts.dtype != torch.int32):
        raise ValueError(f"counts must be int32 (E,) = ({E},), got "
                         f"{counts.dtype} {tuple(counts.shape)}")


def check_kernel_args(xe, w1, w3, w2, counts=None) -> None:
    """Raise on anything the CUDA kernels do not take."""
    ts = [t for t in (xe, w1, w3, w2, counts) if t is not None]
    devices = {t.device for t in ts}
    if len(devices) != 1 or xe.device.type != "cuda":
        raise ValueError(f"the kernel takes xe, the weights and counts on "
                         f"one CUDA device, got {sorted(map(str, devices))}")
    if xe.dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"the kernel takes float32 or bfloat16 xe, got "
                         f"{xe.dtype}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the kernel takes contiguous xe, weights and "
                         "counts")
    E, C, _ = xe.shape
    if E > _MAX_EXPERTS or C > _MAX_ROWS:
        raise ValueError(f"E = {E} or C = {C} exceeds the kernel's grid "
                         f"({_MAX_EXPERTS} experts, {_MAX_ROWS} rows)")
    if min(xe.shape) == 0 or w1.shape[2] == 0:
        raise ValueError(f"empty expert FFN: xe {tuple(xe.shape)}, f "
                         f"{w1.shape[2]}")


def kernel_route(xe, w1, w3, w2) -> str:
    """The route of ``kernel.ROUTES`` that checked xe and weights (already
    in xe's dtype) take."""
    if xe.dtype == torch.float32:
        return "scalar_f32"
    d, f = xe.shape[2], w1.shape[2]
    tma_ok = d % 8 == 0 and f % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (xe, w1, w3, w2) if t is not None)
    return "wgmma_bf16" if tma_ok else "wmma_bf16"


def _forward(xe, w1, w3, w2, counts, act):
    check_kernel_args(xe, w1, w3, w2, counts)
    E, C, _ = xe.shape
    # fresh allocations: 16-byte aligned, as TMA needs
    h = torch.empty((E, C, w1.shape[2]), dtype=xe.dtype, device=xe.device)
    y = torch.empty_like(xe)
    kernel.launch(xe, w1, w3, w2, h, y, counts, act=act,
                  route=kernel_route(xe, w1, w3, w2))
    return y


def expert_ffn_bwd(xe, w1, w3, w2, dy, counts, act: str):
    """(dxe, dw1, dw3, dw2) of the expert FFN for the output gradient dy,
    by the backward kernel on CUDA tensors of one dtype (dw3 None without
    w3), on the route ``kernel_route`` gives the forward on these tensors."""
    check_kernel_args(xe, w1, w3, w2, counts)
    route = kernel_route(xe, w1, w3, w2)
    # autograd may hand over a strided or offset dy; TMA needs 16 bytes
    dy = dy.to(xe.dtype).contiguous()
    if dy.data_ptr() % 16:
        dy = dy.clone()
    E, C, _ = xe.shape
    # fresh allocations: 16-byte aligned, as TMA needs
    ws = torch.empty((2 if w3 is None else 3, E, C, w1.shape[2]),
                     dtype=xe.dtype, device=xe.device)
    dxe, dw1, dw2 = (torch.empty_like(t) for t in (xe, w1, w2))
    dw3 = None if w3 is None else torch.empty_like(w3)
    kernel.launch_bwd(xe, w1, w3, w2, dy, dxe, dw1, dw3, dw2, ws, counts,
                      act=act, route=route)
    return dxe, dw1, dw3, dw2


def _backward(xe, w1, w3, w2, dy, counts, act: str):
    """ExpertFFNFunction's gradients: the kernel on CUDA tensors, the
    plain version on CPU ones."""
    if xe.device.type == "cpu":
        return ref.reference_expert_ffn_bwd(
            xe, {"w1": w1, "w3": w3, "w2": w2}, dy, act, counts)
    return expert_ffn_bwd(xe, w1, w3, w2, dy, counts, act)


class ExpertFFNFunction(torch.autograd.Function):
    """The kernel's forward and the backward kernel on its route, on xe
    and weights of one dtype (w3 may be None)."""

    @staticmethod
    def forward(ctx, xe, w1, w3, w2, counts, act: str):
        y = _forward(xe, w1, w3, w2, counts, act)
        ctx.save_for_backward(xe, w1, w3, w2, counts)
        ctx.act = act
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        xe, w1, w3, w2, counts = ctx.saved_tensors
        E, C, d = xe.shape
        with flops.recorded("moe_gmm_bwd", lambda: cost.bwd_work(
                E * C, E, d, w1.shape[2], w3 is not None, xe.dtype)):
            dxe, dw1, dw3, dw2 = _backward(xe, w1, w3, w2, dy, counts,
                                           ctx.act)
        return dxe, dw1, dw3, dw2, None, None


def expert_ffn(xe, p, act: str = "swiglu", counts=None):
    """xe: (E, C, d); p: {w1: (E,d,f), w3: (E,d,f)?, w2: (E,f,d)};
    counts: int32 (E,) fills of the buckets, or None."""
    _check_shapes(xe, p, act, counts)
    w3 = p.get("w3")
    E, C, d = xe.shape
    f, gated = p["w1"].shape[2], w3 is not None
    shape = (E, C, d, f, gated, xe.dtype)
    devices = {t.device.type for t in (xe, p["w1"], p["w2"], w3, counts)
               if t is not None}
    if devices == {"meta"} or (devices == {"cpu"} and flops.counting()):
        def plain(xe, w1, w3, w2, counts):
            if "meta" in devices:
                return (torch.empty(xe.shape, dtype=xe.dtype,
                                    device=xe.device),)
            return (ref.reference_expert_ffn(
                xe, {"w1": w1, "w3": w3, "w2": w2}, act, counts),)
        return flops.counted_call(
            "moe_gmm", lambda: cost.work(*shape),
            lambda: cost.bwd_work(E * C, E, d, f, gated, xe.dtype), plain,
            (xe, p["w1"], w3, p["w2"], counts), meta="meta" in devices)[0]
    if devices == {"cpu"}:
        return ref.reference_expert_ffn(xe, p, act, counts)
    with flops.recorded("moe_gmm", lambda: cost.work(*shape)):
        w1, w2 = p["w1"].to(xe.dtype), p["w2"].to(xe.dtype)
        w3 = None if w3 is None else w3.to(xe.dtype)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (xe, w1, w3, w2)):
            return ExpertFFNFunction.apply(xe, w1, w3, w2, counts, act)
        return _forward(xe, w1, w3, w2, counts, act)
