"""ctypes binding of the flash-attention CUDA kernels (csrc/flash_attention.cu
and, for the gradient, csrc/flash_attention_bwd.cu).

``launch`` runs the forward on tensors that ``ops.flash_attention`` has
checked, on PyTorch's current stream, and counts the launch in
``LAUNCHES`` and in ``LAUNCHES_BY_ROUTE`` under the route its dtype takes:
bf16 runs on the ``wgmma``/TMA kernel, float32 on the scalar one.
``launch_bwd`` runs the backward's three passes and counts one launch in
``BWD_LAUNCHES`` and ``BWD_LAUNCHES_BY_ROUTE`` under its route: bf16 on
WMMA fragments (``wmma_bf16``), float32 on scalar FMAs (``scalar_f32``).
A run reads the counters
to show which kernel it went through.  The library is built at the first
launch, never at import.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

# the C function's dtype code and the route it picks, by dtype
ROUTES = {torch.bfloat16: (1, "wgmma_bf16"), torch.float32: (0, "scalar_f32")}

# the backward's route, by dtype (the C function takes the same codes)
BWD_ROUTES = {torch.bfloat16: "wmma_bf16", torch.float32: "scalar_f32"}

LAUNCHES = 0    # kernel launches in this process; reset by whoever reads it
LAUNCHES_BY_ROUTE = {route: 0 for _, route in ROUTES.values()}
BWD_LAUNCHES = 0    # backward launches (three passes each), likewise
BWD_LAUNCHES_BY_ROUTE = {route: 0 for route in BWD_ROUTES.values()}

_fn = None
_bwd_fn = None


def reset_launches() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = 0
    BWD_LAUNCHES = 0
    for counts in (LAUNCHES_BY_ROUTE, BWD_LAUNCHES_BY_ROUTE):
        for route in counts:
            counts[route] = 0


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library().repro_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel_fn():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load_library().repro_flash_attention_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def shared_memory_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one thread block of the route ``dtype``
    takes, as the kernel requests it."""
    fn = build.load_library().repro_flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(head_dim, ROUTES[dtype][0])


def bwd_shared_memory_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one thread block of the backward's dK/dV
    and dQ passes on the route ``dtype`` takes, as the kernel requests it."""
    fn = build.load_library().repro_flash_attention_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(head_dim, ROUTES[dtype][0])


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, window: int,
           scale: Optional[float] = None,
           lse: Optional[torch.Tensor] = None) -> None:
    """out <- attention(q, k, v) with scores times ``scale`` (None: 1 /
    sqrt(Dh)); all contiguous (B, S, heads, Dh) on one GPU.  With ``lse``,
    a contiguous (B, H, S) float32 tensor, each row's log-sum-exp of its
    scaled scores is written there too."""
    global LAUNCHES
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    code, route = ROUTES[q.dtype]
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, S, H, KH, Dh, int(causal), int(window), code,
                 1.0 / math.sqrt(Dh) if scale is None else scale, stream)
    build.check_launch(err, f"flash_attention kernel launch ({route})")
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[route] += 1


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
               dsum: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
               dv: torch.Tensor, *, causal: bool, window: int,
               scale: float) -> None:
    """dq, dk, dv <- the gradient of attention(q, k, v) at ``out`` for the
    output gradient ``dout``, from the forward's ``lse``; ``dsum`` is a
    (B, H, S) float32 workspace.  All contiguous on one GPU, q, k, v, out,
    dout, dq, dk, dv of one dtype (bf16 ones on 16-byte boundaries)."""
    global BWD_LAUNCHES
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    code = ROUTES[q.dtype][0]
    route = BWD_ROUTES[q.dtype]
    fn = _bwd_kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, S, H, KH, Dh, int(causal), int(window), code, scale,
                 stream)
    build.check_launch(err, f"flash_attention backward launch ({route})")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BY_ROUTE[route] += 1
