"""ctypes binding of the chunkwise mLSTM CUDA kernels (csrc/mlstm_scan.cu).

``launch`` runs the scores and the state kernel on tensors that
``ops.mlstm_chunkwise`` has checked, on PyTorch's current stream, and counts
the call in ``LAUNCHES`` (one per call: each call launches the two
kernels).  A run reads the counter to show that it went through the
kernels.  The library is built at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

LAUNCHES = 0    # launch() calls in this process; reset by whoever reads it

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load_library().repro_mlstm_scan
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def chunk() -> int:
    """Steps per chunk of the kernels (the last chunk of S is masked)."""
    fn = build.load_library().repro_mlstm_scan_chunk
    fn.restype = ctypes.c_int
    return fn()


def workspace_floats(B: int, S: int, H: int) -> int:
    """Floats of the raw-scores workspace of one call."""
    fn = build.load_library().repro_mlstm_scan_workspace_floats
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn(B, S, H)


def shared_memory_bytes(head_dim: int) -> Tuple[int, bool]:
    """(dynamic shared memory of one state block, whether its slab of C
    lives there) at ``head_dim``."""
    fn = build.load_library().repro_mlstm_scan_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    in_smem = ctypes.c_int(0)
    nbytes = fn(head_dim, ctypes.byref(in_smem))
    return nbytes, bool(in_smem.value)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           ig: torch.Tensor, fg: torch.Tensor,
           init: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
           h: torch.Tensor, C: torch.Tensor, n: torch.Tensor,
           m: torch.Tensor) -> None:
    """(h, C, n, m) <- the chunkwise mLSTM of (q, k, v, ig, fg) from
    ``init`` (or the zero state); all contiguous on one GPU, ig, fg, init,
    h, C, n and m float32."""
    global LAUNCHES
    B, S, H, Dh = q.shape
    fn = _kernel_fn()
    scores = torch.empty((workspace_floats(B, S, H),), dtype=torch.float32,
                         device=q.device)
    C0, n0, m0 = (None, None, None) if init is None else \
        tuple(t.data_ptr() for t in init)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
                 fg.data_ptr(), C0, n0, m0, scores.data_ptr(), h.data_ptr(),
                 C.data_ptr(), n.data_ptr(), m.data_ptr(), B, S, H, Dh,
                 _DTYPE_CODE[q.dtype], math.sqrt(Dh), stream)
    build.check_launch(err, "mlstm_scan kernel launch")
    LAUNCHES += 1
