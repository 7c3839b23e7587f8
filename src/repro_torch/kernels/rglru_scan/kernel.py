"""ctypes binding of the RG-LRU scan CUDA kernel (csrc/rglru_scan.cu).

``launch`` runs the kernel on tensors that ``ops.rglru`` has checked, on
PyTorch's current stream, and counts the launch in ``LAUNCHES``: a run
reads the counter to show that it went through the kernel.  The library is
built at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = 0    # kernel launches in this process; reset by whoever reads it

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library().repro_rglru_scan
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(x: torch.Tensor, lam: torch.Tensor, ga: torch.Tensor,
           gx: torch.Tensor, h0: Optional[torch.Tensor], y: torch.Tensor,
           h_last: torch.Tensor) -> None:
    """(y, h_last) <- the RG-LRU scan of x; all contiguous on one GPU, lam,
    h0, y and h_last float32."""
    global LAUNCHES
    B, S, D = x.shape
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), lam.data_ptr(), ga.data_ptr(), gx.data_ptr(),
                 None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), B, S, D, _DTYPE_CODE[x.dtype],
                 _DTYPE_CODE[ga.dtype], stream)
    build.check_launch(err, "rglru_scan kernel launch")
    LAUNCHES += 1
