"""ctypes binding of the flash-attention CUDA kernel (csrc/flash_attention.cu).

``launch`` runs the kernel on tensors that ``ops.flash_attention`` has
checked, on PyTorch's current stream, and counts the launch in
``LAUNCHES``: a run reads the counter to show that it went through the
kernel.  The library is built at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

LAUNCHES = 0    # kernel launches in this process; reset by whoever reads it

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library().repro_flash_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def shared_memory_bytes(head_dim: int) -> int:
    """Dynamic shared memory of one thread block, as the kernel requests it."""
    fn = build.load_library().repro_flash_attention_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(head_dim)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool, window: int) -> None:
    """out <- attention(q, k, v); all contiguous (B, S, heads, Dh) on one GPU."""
    global LAUNCHES
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, KH, Dh, int(causal), int(window),
                 _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(Dh), stream)
    build.check_launch(err, "flash_attention kernel launch")
    LAUNCHES += 1
