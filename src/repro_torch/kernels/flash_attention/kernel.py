"""ctypes binding of the flash-attention CUDA kernels (csrc/flash_attention.cu
and, for the gradient, csrc/flash_attention_bwd.cu).

``launch`` runs the forward on tensors that ``ops.flash_attention`` has
checked, on PyTorch's current stream, and counts the launch in
``LAUNCHES`` and in ``LAUNCHES_BY_ROUTE`` under the route its dtype takes:
bf16 runs on the ``wgmma``/TMA kernel, float32 on the scalar one.
``launch_bwd`` runs the backward's passes and counts one launch in
``BWD_LAUNCHES`` and ``BWD_LAUNCHES_BY_ROUTE`` under its route: bf16 on
``wgmma`` tiles fed by TMA (``wgmma_bf16``), float32 on scalar FMAs
(``scalar_f32``).  On the bf16 route a KV head's query heads are split
over ``bwd_splits`` blocks where the key tiles alone would not fill the
card; the splits' float32 partial dK and dV go to a workspace that
``launch_bwd`` allocates, and a reduce pass sums them in a fixed order.
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
BWD_ROUTES = {torch.bfloat16: "wgmma_bf16", torch.float32: "scalar_f32"}

# keys of one block of the bf16 dK/dV pass, by the kernel's head dim (its
# DkdvTiles<DH>::BKEYS): a warpgroup of 64 keys each, three at Dh 64, two
# above, sharing 64 at Dh 256
BWD_KEYS_PER_BLOCK = {64: 192, 120: 128, 128: 128, 256: 64}

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
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
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
    """The larger dynamic shared memory of one thread block of the
    backward's dK/dV and dQ passes on the route ``dtype`` takes, as the
    kernels request it."""
    fn = build.load_library().repro_flash_attention_bwd_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(head_dim, ROUTES[dtype][0])


def bwd_splits(B: int, S: int, H: int, KH: int, head_dim: int,
               sms: int) -> int:
    """Into how many shares the bf16 dK/dV pass splits each KV head's
    G = H / KH query heads: 1 where its B * KH * key-tile blocks fill the
    ``sms`` multiprocessors, else enough shares for about two blocks a
    multiprocessor, at most G, each share holding as many heads as the
    first (so none is empty)."""
    G = H // KH
    blocks = -(-S // BWD_KEYS_PER_BLOCK[head_dim]) * B * KH
    if blocks >= sms:
        return 1
    want = min(G, -(-2 * sms // blocks))
    per = -(-G // want)
    return -(-G // per)


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
               scale: float, splits: Optional[int] = None) -> None:
    """dq, dk, dv <- the gradient of attention(q, k, v) at ``out`` for the
    output gradient ``dout``, from the forward's ``lse``; ``dsum`` is a
    (B, H, S) float32 workspace.  All contiguous on one GPU, q, k, v, out,
    dout, dq, dk, dv of one dtype (bf16 ones on 16-byte boundaries).
    ``splits`` (bf16 only; None: ``bwd_splits``) shares each KV head's
    query heads over that many blocks of the dK/dV pass."""
    global BWD_LAUNCHES
    B, S, H, Dh = q.shape
    KH = k.shape[2]
    code = ROUTES[q.dtype][0]
    route = BWD_ROUTES[q.dtype]
    if q.dtype != torch.bfloat16:
        splits = 1
    elif splits is None:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = bwd_splits(B, S, H, KH, Dh, sms)
    # the splits' float32 partial dK and dV, summed by the reduce pass
    part = None if splits == 1 else torch.empty(
        (2, splits, B, S, KH, Dh), dtype=torch.float32, device=q.device)
    fn = _bwd_kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 None if part is None else part.data_ptr(),
                 B, S, H, KH, Dh, int(causal), int(window), code, splits,
                 scale, stream)
    build.check_launch(err, f"flash_attention backward launch ({route})")
    BWD_LAUNCHES += 1
    BWD_LAUNCHES_BY_ROUTE[route] += 1
