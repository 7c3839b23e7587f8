"""Public chunkwise-mLSTM wrapper, with the contract of the JAX package's
``models.xlstm.mlstm_chunkwise``: q, k, v (B, S, H, Dh); ig, fg (B, S, H)
pre-activations; ``init_state`` (C (B, H, Dh, Dh), n (B, H, Dh), m (B, H))
or None.  Returns (h (B, S, H, Dh) float32, (C, n, m) float32).

On tensors that lie on the CPU it computes the plain version (``ref``) at
``chunk``.  On CUDA tensors it launches the CUDA kernels or raises: there is
no fallback, for any S, for ``init_state`` or for a build failure.  The
result does not depend on the chunk, and the kernels take their own (64
steps on the scalar routes, 128 on the wgmma route, the last chunk
masked); ``chunk`` is then only checked.

The route is chosen by dtype and shape (``kernel_route``), before any
launch, never by catching an error:
* float32 q, k, v take ``scalar_f32``, the scalar float32 kernels;
* bf16 q, k, v that TMA can address take ``wgmma_bf16``: Dh a multiple of
  8 (TMA's strides are multiples of 16 bytes) and q, k, v on 16-byte
  boundaries;
* other bf16 q, k, v take ``scalar_bf16``, the scalar kernels' bf16
  instantiation.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mlstm_scan import kernel, ref

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(q, k, v, ig, fg, chunk, init_state) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, Dh), got {tuple(q.shape)}")
    B, S, H, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if tuple(ig.shape) != (B, S, H) or tuple(fg.shape) != (B, S, H):
        raise ValueError(f"ig {tuple(ig.shape)} and fg {tuple(fg.shape)} "
                         f"are not (B, S, H) = {(B, S, H)}")
    if init_state is not None:
        want = ((B, H, Dh, Dh), (B, H, Dh), (B, H))
        got = tuple(tuple(t.shape) for t in init_state)
        if got != want:
            raise ValueError(f"init_state shapes {got} are not (C, n, m) = "
                             f"{want}")
    if min(B, S, H, Dh) == 0:
        raise ValueError(f"empty mLSTM input {tuple(q.shape)}")
    if int(chunk) < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")


def check_kernel_args(q, k, v, ig, fg, init_state) -> None:
    """Raise on anything the CUDA kernels do not take."""
    ts = [q, k, v, ig, fg] + list(init_state or ())
    devices = {t.device for t in ts}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"the kernel takes q, k, v, ig, fg and init_state "
                         f"on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q, k and v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != torch.float32 for t in ts[3:]):
        raise ValueError("the kernel takes float32 ig, fg and init_state")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the kernel takes contiguous q, k, v, ig, fg and "
                         "init_state")


def kernel_route(q, k, v) -> str:
    """The route of ``kernel.ROUTES`` that checked q, k, v take."""
    if q.dtype == torch.float32:
        return "scalar_f32"
    tma_ok = q.shape[-1] % 8 == 0 and \
        all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return "wgmma_bf16" if tma_ok else "scalar_bf16"


def mlstm_chunkwise(q, k, v, ig, fg, *, chunk: int = 64, init_state=None):
    """The chunkwise mLSTM; see ``ref.reference_mlstm``."""
    _check_shapes(q, k, v, ig, fg, chunk, init_state)
    ts = [q, k, v, ig, fg] + list(init_state or ())
    if all(t.device.type == "cpu" for t in ts):
        return ref.reference_mlstm(q, k, v, ig, fg, chunk=chunk,
                                   init_state=init_state)
    build.check_no_grad(
        "mlstm_scan", ts,
        "call it under torch.no_grad() (serving), or train xLSTM on the CPU")
    # the gates and the state are read in float32, as the reference casts
    # them
    ig, fg = ig.float(), fg.float()
    if init_state is not None:
        init_state = tuple(t.float() for t in init_state)
    check_kernel_args(q, k, v, ig, fg, init_state)
    B, S, H, Dh = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    h = torch.empty((B, S, H, Dh), **f32)
    C = torch.empty((B, H, Dh, Dh), **f32)
    n = torch.empty((B, H, Dh), **f32)
    m = torch.empty((B, H), **f32)
    kernel.launch(q, k, v, ig, fg, init_state, h, C, n, m,
                  kernel_route(q, k, v))
    return h, (C, n, m)
