"""ctypes binding of the RG-LRU scan CUDA kernels (csrc/rglru_scan.cu and,
for the gradient, csrc/rglru_scan_bwd.cu).

``launch`` runs the forward on tensors that ``ops.rglru`` has checked, on
PyTorch's current stream, and counts the launch in ``LAUNCHES`` and in
``LAUNCHES_BY_ROUTE`` under its route:

* ``fused_bias``: ga and gx are the bias-free gate products and the kernel
  adds the float32 biases b_a and b_i itself;
* ``gates``: ga and gx are the whole gate pre-activations.

``launch_bwd`` runs the backward's four passes and counts one launch in
``BWD_LAUNCHES`` and ``BWD_LAUNCHES_BY_ROUTE``, under the same routes.
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
BWD_LAUNCHES = 0    # backward launches (four passes each), likewise
BWD_LAUNCHES_BY_ROUTE = {route: 0 for route in ROUTES}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
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
        fn = build.load_library().repro_rglru_scan
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel_fn():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load_library().repro_rglru_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def bwd_workspace_bytes(B: int, S: int, D: int) -> int:
    """Bytes of the float32 workspace one backward call allocates: each
    chunk's product of a and carry, and its partial sums of dlam, db_a and
    db_i, per batch row and channel."""
    fn = build.load_library().repro_rglru_scan_bwd_workspace_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn(B, S, D)


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


def launch_bwd(x: torch.Tensor, lam: torch.Tensor, ga: torch.Tensor,
               gx: torch.Tensor, b_a: Optional[torch.Tensor],
               b_i: Optional[torch.Tensor], h0: Optional[torch.Tensor],
               y: torch.Tensor, dy: torch.Tensor,
               dh_last: Optional[torch.Tensor], dx: torch.Tensor,
               dga: torch.Tensor, dgx: torch.Tensor, dlam: torch.Tensor,
               db_a: Optional[torch.Tensor], db_i: Optional[torch.Tensor],
               dh0: Optional[torch.Tensor]) -> None:
    """(dx, dga, dgx, dlam, db_a, db_i, dh0) <- the gradient of the scan of
    x at its output y for the gradients dy and dh_last (None: zero); x, lam,
    ga, gx, b_a, b_i, h0 as ``launch`` took them, y, dy, dh_last, dlam,
    db_a, db_i (given with the biases) and dh0 (or None) float32, dx in x's
    dtype, dga and dgx in ga's; all contiguous on one GPU."""
    global BWD_LAUNCHES
    B, S, D = x.shape
    route = "gates" if b_a is None else "fused_bias"
    fn = _bwd_kernel_fn()
    ws = torch.empty((bwd_workspace_bytes(B, S, D),), dtype=torch.uint8,
                     device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), lam.data_ptr(), ga.data_ptr(), gx.data_ptr(),
                 _ptr(b_a), _ptr(b_i), _ptr(h0), y.data_ptr(),
                 dy.data_ptr(), _ptr(dh_last), ws.data_ptr(), dx.data_ptr(),
                 dga.data_ptr(), dgx.data_ptr(), dlam.data_ptr(),
                 _ptr(db_a), _ptr(db_i), _ptr(dh0), B, S, D,
                 _DTYPE_CODE[x.dtype], _DTYPE_CODE[ga.dtype], stream)
    build.check_launch(err, f"rglru_scan backward launch ({route})")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BY_ROUTE[route] += 1
