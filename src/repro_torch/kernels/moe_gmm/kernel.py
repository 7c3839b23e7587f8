"""ctypes binding of the grouped expert-FFN CUDA kernels (csrc/moe_gmm.cu
and, for the gradient, csrc/moe_gmm_bwd.cu).

``launch`` runs one route's gate/up and down kernels on tensors that
``ops.expert_ffn`` has checked and routed, on PyTorch's current stream,
and counts the call in ``LAUNCHES`` and in ``LAUNCHES_BY_ROUTE`` under its
route (one per call: each call launches the two kernels).  ``launch_bwd``
runs the backward's passes (up, dx, weights) on the forward's route and
counts one launch in ``BWD_LAUNCHES`` and ``BWD_LAUNCHES_BY_ROUTE``.  The
routes:

* ``wgmma_bf16``: bf16 that TMA can address; ``wgmma`` on tiles that TMA
  loads, persistent CTAs;
* ``wmma_bf16``: other bf16, on WMMA fragments (the backward on scalar
  FMAs with float32 accumulators);
* ``scalar_f32``: float32, on scalar FMAs.

A run reads the counters to show which kernels it went through.  The
library is built at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, counters

# the C function's route code, by route name
ROUTES = {"scalar_f32": 0, "wmma_bf16": 1, "wgmma_bf16": 2}
ACT_CODE = {"swiglu": 0, "geglu": 1, "gelu": 1, "relu2": 2}

LAUNCHES = 0    # launch() calls in this process; reset by whoever reads it
LAUNCHES_BY_ROUTE = {route: 0 for route in ROUTES}
BWD_LAUNCHES = 0    # backward launches (its passes each), likewise
BWD_LAUNCHES_BY_ROUTE = {route: 0 for route in ROUTES}

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
        fn = build.load_library().repro_moe_gmm_ffn
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel_fn():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load_library().repro_moe_gmm_ffn_bwd
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def launch(xe: torch.Tensor, w1: torch.Tensor, w3: Optional[torch.Tensor],
           w2: torch.Tensor, h: torch.Tensor, y: torch.Tensor,
           counts: Optional[torch.Tensor], *, act: str, route: str) -> None:
    """y <- expert FFN of xe on ``route``, through the workspace h (E, C,
    f), rows at or past ``counts`` (int32 (E,), or None: all live) zero;
    all contiguous, of one dtype, on one GPU."""
    E, C, d = xe.shape
    f = w1.shape[-1]
    fn = _kernel_fn()
    with torch.cuda.device(xe.device):
        stream = torch.cuda.current_stream(xe.device).cuda_stream
        err = fn(xe.data_ptr(), w1.data_ptr(),
                 None if w3 is None else w3.data_ptr(), w2.data_ptr(),
                 h.data_ptr(), y.data_ptr(),
                 None if counts is None else counts.data_ptr(),
                 E, C, d, f, ACT_CODE[act], ROUTES[route], stream)
    build.check_launch(err, f"moe_gmm kernel launch ({route})")
    counters.bump(globals(), "LAUNCHES", LAUNCHES_BY_ROUTE, route)


def launch_bwd(xe: torch.Tensor, w1: torch.Tensor,
               w3: Optional[torch.Tensor], w2: torch.Tensor, dy: torch.Tensor,
               dxe: torch.Tensor, dw1: torch.Tensor,
               dw3: Optional[torch.Tensor], dw2: torch.Tensor,
               ws: torch.Tensor, counts: Optional[torch.Tensor], *, act: str,
               route: str) -> None:
    """dxe, dw1, dw3, dw2 <- the gradients of the expert FFN of xe for the
    output gradient dy on ``route``, through the workspace ws (2 or 3, E,
    C, f) (h, da1, da3); rows at or past ``counts`` (int32 (E,), or None:
    all live) add nothing and their dxe is 0; dw3 None without w3.  All
    contiguous, of one dtype, on one GPU (on ``wgmma_bf16``, on 16-byte
    boundaries)."""
    E, C, d = xe.shape
    f = w1.shape[-1]
    fn = _bwd_kernel_fn()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(xe.device):
        stream = torch.cuda.current_stream(xe.device).cuda_stream
        err = fn(xe.data_ptr(), w1.data_ptr(), ptr(w3), w2.data_ptr(),
                 dy.data_ptr(), dxe.data_ptr(), dw1.data_ptr(), ptr(dw3),
                 dw2.data_ptr(), ws.data_ptr(), ptr(counts), E, C, d, f,
                 ACT_CODE[act], ROUTES[route], stream)
    build.check_launch(err, f"moe_gmm backward launch ({route})")
    counters.bump(globals(), "BWD_LAUNCHES", BWD_LAUNCHES_BY_ROUTE, route)
