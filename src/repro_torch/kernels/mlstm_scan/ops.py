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

Under grad mode, with an input that requires grad, the kernels run inside
``MLSTMScanFunction``: the forward also writes each row's stabiliser m_t
and denominator den_t, and the backward is the hand-written kernels of
``csrc/mlstm_scan_bwd.cu`` on the route the forward took (``wgmma_bf16``:
split-bf16 ``wgmma`` products on the states of each chunk;
``scalar_bf16`` and ``scalar_f32``: scalar float32 FMAs), to q, k, v, ig
and fg; the gates' last step (a reverse cumsum over S) is PyTorch.
No gradient flows into or out of the state: a gradient that reaches the
final (C, n, m) raises, as does an ``init_state`` that requires grad.
Otherwise (serving, under ``no_grad`` or ``inference_mode``) the forward
writes no statistics.

On ``meta`` tensors it computes nothing and returns empty outputs of the
right shapes.  Under a ``distributed.flops.FlopCounter`` each call, and
each backward, counts by ``cost.work`` and ``cost.bwd_work`` on every
device.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.distributed import flops
from repro_torch.kernels.mlstm_scan import cost, kernel, ref

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


def _forward(q, k, v, ig, fg, init_state, route, with_stats: bool):
    B, S, H, Dh = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    h = torch.empty((B, S, H, Dh), **f32)
    C = torch.empty((B, H, Dh, Dh), **f32)
    n = torch.empty((B, H, Dh), **f32)
    m = torch.empty((B, H), **f32)
    stats = (torch.empty((B, S, H), **f32), torch.empty((B, S, H), **f32)) \
        if with_stats else None
    kernel.launch(q, k, v, ig, fg, init_state, h, C, n, m, route,
                  stats=stats)
    return h, (C, n, m), stats


def fg_grad(fg, dig, rows):
    """fg's gradient from the backward kernel's dig and row sums: dF = rows
    - dig, summed from each step to the end of S, times d logsigmoid(fg) =
    sigmoid(-fg)."""
    dF = rows - dig
    dlf = torch.flip(torch.cumsum(torch.flip(dF, (1,)), dim=1), (1,))
    return dlf * torch.sigmoid(-fg)


class MLSTMScanFunction(torch.autograd.Function):
    """The kernels' forward (with its row statistics) and backward on
    checked float32-gated inputs (``check_kernel_args``); returns
    (h, C, n, m).  The initial state (C0, n0, m0, or three Nones) is a
    constant."""

    @staticmethod
    def forward(ctx, q, k, v, ig, fg, C0, n0, m0, route: str):
        if any(ctx.needs_input_grad[5:8]):
            raise RuntimeError(
                "mlstm_scan: init_state requires grad, and the backward "
                "kernel carries no gradient into the state; pass it "
                "detached")
        init = None if C0 is None else (C0, n0, m0)
        h, (C, n, m), stats = _forward(q, k, v, ig, fg, init, route,
                                       with_stats=True)
        ctx.save_for_backward(q, k, v, ig, fg, C0, n0, m0, h, *stats)
        ctx.route = route
        ctx.set_materialize_grads(False)
        return h, C, n, m

    @staticmethod
    @once_differentiable
    def backward(ctx, dh, dC, dn, dm):
        if dC is not None or dn is not None or dm is not None:
            raise RuntimeError(
                "mlstm_scan: a gradient reached the final state (C, n, m), "
                "and the backward kernel carries none through the state; "
                "only h may be differentiated")
        q, k, v, ig, fg, C0, n0, m0, h, m_t, den = ctx.saved_tensors
        if dh is None:
            return (None,) * 9
        with flops.recorded("mlstm_scan_bwd", lambda: cost.bwd_work(
                *q.shape, q.dtype)):
            dh = dh.float().contiguous()
            if dh.data_ptr() % 16:   # a view off TMA's and float4's alignment
                dh = dh.clone()
            init = None if C0 is None else (C0, n0, m0)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            dig, rows = torch.empty_like(ig), torch.empty_like(ig)
            kernel.launch_bwd(q, k, v, ig, fg, init, h, (m_t, den), dh, dq,
                              dk, dv, dig, rows, ctx.route)
            dfg = fg_grad(fg, dig, rows)
        return dq, dk, dv, dig, dfg, None, None, None, None


def mlstm_chunkwise(q, k, v, ig, fg, *, chunk: int = 64, init_state=None):
    """The chunkwise mLSTM; see ``ref.reference_mlstm``."""
    _check_shapes(q, k, v, ig, fg, chunk, init_state)
    ts = [q, k, v, ig, fg] + list(init_state or ())
    shape = (*q.shape, q.dtype)

    def work():
        return cost.work(*shape, init_state is not None)

    def bwd_work():
        return cost.bwd_work(*shape)
    devices = {t.device.type for t in ts}
    if devices == {"meta"} or (devices == {"cpu"} and flops.counting()):
        def plain(q, k, v, ig, fg, *init):
            if "meta" in devices:
                B, _, H, Dh = q.shape
                f32 = dict(dtype=torch.float32, device=q.device)
                return (torch.empty(q.shape, **f32),
                        torch.empty((B, H, Dh, Dh), **f32),
                        torch.empty((B, H, Dh), **f32),
                        torch.empty((B, H), **f32))
            h, state = ref.reference_mlstm(q, k, v, ig, fg, chunk=chunk,
                                           init_state=init or None)
            return (h, *state)
        h, C, n, m = flops.counted_call("mlstm_scan", work, bwd_work, plain,
                                        ts, meta="meta" in devices)
        return h, (C, n, m)
    if devices == {"cpu"}:
        return ref.reference_mlstm(q, k, v, ig, fg, chunk=chunk,
                                   init_state=init_state)
    with flops.recorded("mlstm_scan", work):
        # the gates and the state are read in float32, as the reference
        # casts them
        ig, fg = ig.float(), fg.float()
        if init_state is not None:
            init_state = tuple(t.float() for t in init_state)
        check_kernel_args(q, k, v, ig, fg, init_state)
        route = kernel_route(q, k, v)
        if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
            h, C, n, m = MLSTMScanFunction.apply(
                q, k, v, ig, fg, *(init_state or (None, None, None)), route)
            return h, (C, n, m)
        h, state, _ = _forward(q, k, v, ig, fg, init_state, route,
                               with_stats=False)
        return h, state
