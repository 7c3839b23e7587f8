"""ctypes binding of the grouped expert-FFN CUDA kernels (csrc/moe_gmm.cu).

``launch`` runs the gate/up and the down kernel on tensors that
``ops.expert_ffn`` has checked, on PyTorch's current stream, and counts the
call in ``LAUNCHES`` (one per call: each call launches the two kernels).  A
run reads the counter to show that it went through the kernels.  The
library is built at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

LAUNCHES = 0    # launch() calls in this process; reset by whoever reads it

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ACT_CODE = {"swiglu": 0, "geglu": 1, "gelu": 1, "relu2": 2}
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library().repro_moe_gmm_ffn
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def launch(xe: torch.Tensor, w1: torch.Tensor, w3: Optional[torch.Tensor],
           w2: torch.Tensor, h: torch.Tensor, y: torch.Tensor, *,
           act: str) -> None:
    """y <- expert FFN of xe, through the workspace h (E, C, f); all
    contiguous, of one dtype, on one GPU."""
    global LAUNCHES
    E, C, d = xe.shape
    f = w1.shape[-1]
    fn = _kernel_fn()
    with torch.cuda.device(xe.device):
        stream = torch.cuda.current_stream(xe.device).cuda_stream
        err = fn(xe.data_ptr(), w1.data_ptr(),
                 None if w3 is None else w3.data_ptr(), w2.data_ptr(),
                 h.data_ptr(), y.data_ptr(), E, C, d, f, ACT_CODE[act],
                 _DTYPE_CODE[xe.dtype], stream)
    build.check_launch(err, "moe_gmm kernel launch")
    LAUNCHES += 1
