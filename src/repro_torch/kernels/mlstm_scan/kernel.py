"""ctypes binding of the chunkwise mLSTM CUDA kernels (csrc/mlstm_scan.cu
and, for the gradient, csrc/mlstm_scan_bwd.cu).

``launch`` runs one route's kernels on tensors that ``ops.mlstm_chunkwise``
has checked and routed, on PyTorch's current stream, and counts the call
in ``LAUNCHES`` and in ``LAUNCHES_BY_ROUTE`` under its route (one per
call, whatever the number of kernels the route launches):

* ``wgmma_bf16``: bf16 q, k, v that TMA can address; a gate pass, a
  q k^T pass, a state pass and an output pass with the products on bf16
  ``wgmma``;
* ``scalar_bf16``: other bf16 q, k, v, on the scalar float32 kernels;
* ``scalar_f32``: float32 q, k, v, on the scalar float32 kernels.

With ``stats`` the forward also writes each row's stabiliser m_t and
denominator den_t for the backward.  ``launch_bwd`` runs the backward on
the route its forward took (``BWD_ROUTES``) and counts one launch in
``BWD_LAUNCHES`` and ``BWD_LAUNCHES_BY_ROUTE`` under it:

* ``wgmma_bf16``: C^T and D^T materialised per chunk of 128 steps, then
  dq, dk and dv per (chunk, column tile), the products on bf16 ``wgmma``
  with the float32 factors split into bf16 hi and lo;
* ``scalar_bf16`` and ``scalar_f32``: five passes on scalar float32 FMAs,
  chunks of 64 steps.

A run reads the counters to show which kernels it went through.  The
library is built at the first launch, never at import.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build, counters

# the C function's route code, by route name
ROUTES = {"scalar_f32": 0, "scalar_bf16": 1, "wgmma_bf16": 2}
# the kernels of each route whose dynamic shared memory
# ``shared_memory_bytes`` reports, in the C function's pass order
PASSES = {"scalar_f32": ("state",), "scalar_bf16": ("state",),
          "wgmma_bf16": ("scores", "states", "outputs")}

LAUNCHES = 0    # launch() calls in this process; reset by whoever reads it
LAUNCHES_BY_ROUTE = {route: 0 for route in ROUTES}
# the backward's routes, as the forward's, each the route of the forward
# it differentiates (the C function's route code)
BWD_ROUTES = dict(ROUTES)
BWD_LAUNCHES = 0    # backward launches (one per call), likewise
BWD_LAUNCHES_BY_ROUTE = {route: 0 for route in BWD_ROUTES}

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
        fn = build.load_library().repro_mlstm_scan
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _bwd_kernel_fn():
    global _bwd_fn
    if _bwd_fn is None:
        fn = build.load_library().repro_mlstm_scan_bwd
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bwd_fn = fn
    return _bwd_fn


def bwd_chunk(route: str) -> int:
    """Steps per chunk of the backward's ``route`` (the last chunk of S is
    masked)."""
    fn = build.load_library().repro_mlstm_scan_bwd_chunk
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(BWD_ROUTES[route])


def bwd_workspace_bytes(B: int, S: int, H: int, Dh: int, route: str) -> int:
    """Bytes of the workspace one backward call of ``route`` allocates: on
    the scalar routes per row the chunk's cumulative log-forget and gate
    weights and the float32 inter-chunk parts of dq, dk and dv (3 B S H Dh
    floats); on the wgmma route the gates, the per-row scalars, the chunks'
    scores, dnum as bf16 hi and lo, C^T and D^T at each chunk's boundary
    (bf16 hi and lo) for one segment of S (at most 1 GiB of each), and the
    float32 states carried between segments."""
    fn = build.load_library().repro_mlstm_scan_bwd_workspace_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn(B, S, H, Dh, BWD_ROUTES[route])


def chunk(route: str) -> int:
    """Steps per chunk of ``route`` (the last chunk of S is masked)."""
    fn = build.load_library().repro_mlstm_scan_chunk
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(ROUTES[route])


def workspace_bytes(B: int, S: int, H: int, Dh: int, route: str) -> int:
    """Bytes of the workspace one call of ``route`` allocates: the raw
    scores on the scalar routes; the gates, the scores, and n and C^T (bf16
    hi and lo) at each chunk's entry of one segment of S (at most 1 GiB of
    C^T), on the wgmma route."""
    fn = build.load_library().repro_mlstm_scan_workspace_bytes
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn(B, S, H, Dh, ROUTES[route])


def shared_memory_bytes(head_dim: int, route: str) -> Dict[str, int]:
    """{kernel: dynamic shared memory of one block} of ``route`` at
    ``head_dim`` (``PASSES``), as the kernels request it."""
    fn = build.load_library().repro_mlstm_scan_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    flag = ctypes.c_int(0)
    return {name: fn(head_dim, ROUTES[route], i, ctypes.byref(flag))
            for i, name in enumerate(PASSES[route])}


def state_in_shared_memory(head_dim: int) -> bool:
    """Whether the scalar state kernel keeps its slab of C in shared memory
    at ``head_dim`` (else in device memory, through L2)."""
    fn = build.load_library().repro_mlstm_scan_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    flag = ctypes.c_int(0)
    fn(head_dim, ROUTES["scalar_f32"], 0, ctypes.byref(flag))
    return bool(flag.value)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           ig: torch.Tensor, fg: torch.Tensor,
           init: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
           h: torch.Tensor, C: torch.Tensor, n: torch.Tensor,
           m: torch.Tensor, route: str,
           stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
    """(h, C, n, m) <- the chunkwise mLSTM of (q, k, v, ig, fg) from
    ``init`` (or the zero state) on ``route``; all contiguous on one GPU,
    ig, fg, init, h, C, n and m float32.  With ``stats``, two (B, S, H)
    float32 tensors, each row's stabiliser m_t and denominator den_t (before
    its clamp) are written there too."""
    B, S, H, Dh = q.shape
    fn = _kernel_fn()
    # 16-byte aligned, as TMA needs (the caching allocator's blocks are)
    ws = torch.empty((workspace_bytes(B, S, H, Dh, route),),
                     dtype=torch.uint8, device=q.device)
    C0, n0, m0 = (None, None, None) if init is None else \
        tuple(t.data_ptr() for t in init)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
                 fg.data_ptr(), C0, n0, m0, ws.data_ptr(), h.data_ptr(),
                 C.data_ptr(), n.data_ptr(), m.data_ptr(),
                 *((None, None) if stats is None else
                   (stats[0].data_ptr(), stats[1].data_ptr())),
                 B, S, H, Dh, ROUTES[route], math.sqrt(Dh), stream)
    build.check_launch(err, f"mlstm_scan kernel launch ({route})")
    counters.bump(globals(), "LAUNCHES", LAUNCHES_BY_ROUTE, route)


def launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               ig: torch.Tensor, fg: torch.Tensor,
               init: Optional[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]],
               h: torch.Tensor, stats: Tuple[torch.Tensor, torch.Tensor],
               dh: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
               dv: torch.Tensor, dig: torch.Tensor,
               rows: torch.Tensor, route: str) -> None:
    """(dq, dk, dv, dig, rows) <- the gradient of the mLSTM at its output h
    for dh on ``route``, from the row statistics ``stats`` (m_t, den_t) of
    a forward on the same route; q, k, v, ig, fg, init as ``launch`` took
    them, h, dh float32, dq, dk, dv in q's dtype, dig (the gradient of ig)
    and rows (each row's sum of dS o (q~ k^T), for fg's gradient) (B, S, H)
    float32; all contiguous on one GPU, and on the wgmma route h and dh on
    16-byte boundaries."""
    B, S, H, Dh = q.shape
    fn = _bwd_kernel_fn()
    ws = torch.empty((bwd_workspace_bytes(B, S, H, Dh, route),),
                     dtype=torch.uint8, device=q.device)
    C0, n0, m0 = (None, None, None) if init is None else \
        tuple(t.data_ptr() for t in init)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
                 fg.data_ptr(), C0, n0, m0, h.data_ptr(), dh.data_ptr(),
                 stats[0].data_ptr(), stats[1].data_ptr(), ws.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 dig.data_ptr(), rows.data_ptr(), B, S, H, Dh,
                 BWD_ROUTES[route], math.sqrt(Dh), stream)
    build.check_launch(err, f"mlstm_scan backward launch ({route})")
    counters.bump(globals(), "BWD_LAUNCHES", BWD_LAUNCHES_BY_ROUTE,
                  route)
