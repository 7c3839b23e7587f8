"""ctypes binding of the grouped expert-FFN CUDA kernels (csrc/moe_gmm.cu).

``launch`` runs one route's gate/up and down kernels on tensors that
``ops.expert_ffn`` has checked and routed, on PyTorch's current stream,
and counts the call in ``LAUNCHES`` and in ``LAUNCHES_BY_ROUTE`` under its
route (one per call: each call launches the two kernels):

* ``wgmma_bf16``: bf16 that TMA can address; ``wgmma`` on tiles that TMA
  loads, persistent CTAs;
* ``wmma_bf16``: other bf16, on WMMA fragments;
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
# backward calls of ops.ExpertFFNFunction (plain grouped products, no
# kernel of this module), counted with the launches
BWD_CALLS = 0

_fn = None


def reset_launches() -> None:
    global LAUNCHES, BWD_CALLS
    LAUNCHES = 0
    BWD_CALLS = 0
    for route in LAUNCHES_BY_ROUTE:
        LAUNCHES_BY_ROUTE[route] = 0


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library().repro_moe_gmm_ffn
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
