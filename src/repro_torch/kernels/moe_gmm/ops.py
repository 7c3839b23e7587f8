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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.moe_gmm import kernel, ref

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


def expert_ffn(xe, p, act: str = "swiglu", counts=None):
    """xe: (E, C, d); p: {w1: (E,d,f), w3: (E,d,f)?, w2: (E,f,d)};
    counts: int32 (E,) fills of the buckets, or None."""
    _check_shapes(xe, p, act, counts)
    w3 = p.get("w3")
    if all(t.device.type == "cpu"
           for t in (xe, p["w1"], p["w2"], w3, counts) if t is not None):
        return ref.reference_expert_ffn(xe, p, act, counts)
    build.check_no_grad(
        "moe_gmm", (xe, p["w1"], p["w2"], w3),
        "call it under torch.no_grad() (serving), or train MoE with "
        "moe_dispatch='einsum'")
    w1, w2 = p["w1"].to(xe.dtype), p["w2"].to(xe.dtype)
    w3 = None if w3 is None else w3.to(xe.dtype)
    check_kernel_args(xe, w1, w3, w2, counts)
    E, C, _ = xe.shape
    # fresh allocations: 16-byte aligned, as TMA needs
    h = torch.empty((E, C, w1.shape[2]), dtype=xe.dtype, device=xe.device)
    y = torch.empty_like(xe)
    kernel.launch(xe, w1, w3, w2, h, y, counts, act=act,
                  route=kernel_route(xe, w1, w3, w2))
    return y
