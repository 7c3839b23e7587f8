"""ctypes binding of the RG-LRU scan CUDA kernel (csrc/rglru_scan.cu).

``launch`` runs the kernel on tensors that ``ops.rglru`` has checked, on
PyTorch's current stream, and counts the launch in ``LAUNCHES`` and in
``LAUNCHES_BY_ROUTE`` under its route:

* ``fused_bias``: ga and gx are the bias-free gate products and the kernel
  adds the float32 biases b_a and b_i itself;
* ``gates``: ga and gx are the whole gate pre-activations.

A run reads the counters to show which kernels it went through.  The
library is built at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

ROUTES = ("fused_bias", "gates")

LAUNCHES = 0    # kernel launches in this process; reset by whoever reads it
LAUNCHES_BY_ROUTE = {route: 0 for route in ROUTES}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for route in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[route] = 0


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library().repro_rglru_scan
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def launch(x: torch.Tensor, lam: torch.Tensor, ga: torch.Tensor,
           gx: torch.Tensor, b_a: Optional[torch.Tensor],
           b_i: Optional[torch.Tensor], h0: Optional[torch.Tensor],
           y: torch.Tensor, h_last: torch.Tensor) -> None:
    """(y, h_last) <- the RG-LRU scan of x; all contiguous on one GPU, lam,
    b_a, b_i (both given or both None), h0, y and h_last float32."""
    global LAUNCHES
    B, S, D = x.shape
    route = "gates" if b_a is None else "fused_bias"
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), lam.data_ptr(), ga.data_ptr(), gx.data_ptr(),
                 _ptr(b_a), _ptr(b_i), _ptr(h0), y.data_ptr(),
                 h_last.data_ptr(), B, S, D, _DTYPE_CODE[x.dtype],
                 _DTYPE_CODE[ga.dtype], stream)
    build.check_launch(err, f"rglru_scan kernel launch ({route})")
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[route] += 1
