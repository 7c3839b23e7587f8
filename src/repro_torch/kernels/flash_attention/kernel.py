"""ctypes binding of the flash-attention CUDA kernel (csrc/flash_attention.cu).

``launch`` runs the kernel on tensors that ``ops.flash_attention`` has
checked, on PyTorch's current stream, and counts the launch in
``LAUNCHES`` and in ``LAUNCHES_BY_ROUTE`` under the route its dtype takes:
bf16 runs on the ``wgmma``/TMA kernel, float32 on the scalar one.  A run
reads the counters to show which kernel it went through.  The library is
built at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

# the C function's dtype code and the route it picks, by dtype
ROUTES = {torch.bfloat16: (1, "wgmma_bf16"), torch.float32: (0, "scalar_f32")}

LAUNCHES = 0    # kernel launches in this process; reset by whoever reads it
LAUNCHES_BY_ROUTE = {route: 0 for _, route in ROUTES.values()}

_fn = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for route in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[route] = 0


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library().repro_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def shared_memory_bytes(head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one thread block of the route ``dtype``
    takes, as the kernel requests it."""
    fn = build.load_library().repro_flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(head_dim, ROUTES[dtype][0])


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, window: int,
           scale: Optional[float] = None) -> None:
    """out <- attention(q, k, v) with scores times ``scale`` (None: 1 /
    sqrt(Dh)); all contiguous (B, S, heads, Dh) on one GPU."""
    global LAUNCHES
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    code, route = ROUTES[q.dtype]
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, KH, Dh, int(causal), int(window), code,
                 1.0 / math.sqrt(Dh) if scale is None else scale, stream)
    build.check_launch(err, f"flash_attention kernel launch ({route})")
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[route] += 1
