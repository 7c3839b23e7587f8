#!/usr/bin/env python3
"""Run the RG-LRU backward kernel's CUDA source on the CPU, against the
plain backward, to check its indexing without a card.

    python3 tools/cuda_emu/rglru_bwd_emu.py            # the default cases
    python3 tools/cuda_emu/rglru_bwd_emu.py "(2, 65, 200, 'bf16', 'bf16', True, True, True, False)"

Each case is (B, S, D, x dtype, gate dtype, h0, dh_last, fused biases,
off a 16-byte boundary).  ``csrc/rglru_scan_bwd.cu`` is rewritten for g++
by ``emu_build.py`` (cp.async as copies queued per thread and carried out
at the wait) and its C entry point takes CPU tensors through ctypes.  y is
the plain forward's; the workspace, the outputs and shared memory start as
NaN, so a read of what nothing wrote shows.  Each gradient is held against
``ref.reference_rglru_bwd`` relative to its max |.| (floored at 1e-3 of the
largest), as the card tests hold them: bf16 dx, dga, dgx at 2e-2, the rest
at 1e-4.  The cases cover S 1, the windows' edges (63, 64, 65 for
float32 gates, 127, 129 for bf16), many windows with a ragged last one
(S 200, 1025, 1100), D not a multiple of 8 and a tensor off a 16-byte
boundary (both on plain loads), and D 4100.  What it
cannot check: timing, and races that the card's scheduling would expose.
"""
from __future__ import annotations

import ast
import ctypes
import math
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import emu_build  # noqa: E402
from repro_torch.kernels.rglru_scan import ref  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CODE = {torch.float32: 0, torch.bfloat16: 1}
NAMES = ("dx", "dlam", "dga", "dgx", "dh0", "db_a", "db_i")
CASES = [(2, 1, 256, "bf16", "bf16", True, True, True, False),
         (3, 63, 77, "f32", "f32", True, True, False, False),
         (2, 64, 128, "bf16", "bf16", False, True, True, False),
         (2, 65, 200, "bf16", "f32", True, False, True, False),
         (2, 127, 96, "bf16", "bf16", True, True, True, False),
         (1, 129, 96, "bf16", "bf16", False, True, False, False),
         (1, 200, 64, "f32", "f32", True, True, True, False),
         (2, 1100, 512, "bf16", "bf16", True, True, True, False),
         (1, 1025, 1024, "f32", "f32", True, True, True, False),
         (2, 65, 128, "bf16", "bf16", True, True, True, True),
         (1, 129, 4100, "f32", "f32", True, True, True, False)]


def build(root: pathlib.Path = ROOT):
    """The emulated library of ``root``'s backward source."""
    return emu_build.build(["rglru_scan/csrc/rglru_scan_bwd.cu"], "rglru_bwd",
                           root)


class Lib:
    def __init__(self, path: pathlib.Path):
        lib = ctypes.CDLL(str(path))
        self.bwd = lib.repro_rglru_scan_bwd
        self.bwd.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        self.bwd.restype = ctypes.c_int
        self.ws = lib.repro_rglru_scan_bwd_workspace_bytes
        self.ws.argtypes = [ctypes.c_int] * 3
        self.ws.restype = ctypes.c_longlong


def _off16(t):
    """t's values in a contiguous tensor 2 or 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _ptr(t):
    return None if t is None else t.data_ptr()


def run_case(lib, B, S, D, x_dt, g_dt, with_h0, with_dhl, fused, off16,
             seed=0):
    """{gradient: error relative to the plain one's scale}."""
    x_dt, g_dt = DTYPES[x_dt], DTYPES[g_dt]
    g = torch.Generator().manual_seed(seed)
    u = 0.9 + 0.099 * torch.rand((D,), generator=g)
    lam = torch.log(torch.expm1(-torch.log(u) / ref.RGLRU_C))
    x, ga, gx, dy = (torch.randn((B, S, D), generator=g) for _ in range(4))
    x, ga, gx = x.to(x_dt), ga.to(g_dt), gx.to(g_dt)
    h0 = torch.randn((B, D), generator=g) if with_h0 else None
    dh_last = torch.randn((B, D), generator=g) if with_dhl else None
    b_a, b_i = (0.5 * torch.randn((D,), generator=g) for _ in range(2)) \
        if fused else (None, None)
    if off16:
        x, ga = _off16(x), _off16(ga)
    y, _ = ref.reference_rglru(x, lam, ga, gx, h0, b_a=b_a, b_i=b_i)
    nan = float("nan")
    dx, dga, dgx = (torch.full(t.shape, nan, dtype=t.dtype)
                    for t in (x, ga, gx))
    dlam = torch.full((D,), nan)
    db_a, db_i = (torch.full((D,), nan) for _ in range(2)) if fused \
        else (None, None)
    dh0 = torch.full((B, D), nan) if with_h0 else None
    ws = torch.full((lib.ws(B, S, D),), 0xFF, dtype=torch.uint8)
    err = lib.bwd(x.data_ptr(), lam.data_ptr(), ga.data_ptr(), gx.data_ptr(),
                  _ptr(b_a), _ptr(b_i), _ptr(h0), y.data_ptr(), dy.data_ptr(),
                  _ptr(dh_last), ws.data_ptr(), dx.data_ptr(), dga.data_ptr(),
                  dgx.data_ptr(), dlam.data_ptr(), _ptr(db_a), _ptr(db_i),
                  _ptr(dh0), B, S, D, CODE[x_dt], CODE[g_dt], None)
    if err:
        raise RuntimeError(f"backward refused: {err}")
    got = (dx, dlam, dga, dgx, dh0, db_a, db_i)
    want = ref.reference_rglru_bwd(x, lam, ga, gx, y, dy, h0, dh_last,
                                   b_a=b_a, b_i=b_i)
    top = max(float(w.abs().max()) for w in want if w is not None)
    rounded = {"dx": x_dt, "dga": g_dt, "dgx": g_dt}   # outputs in bf16?
    errs, tols = {}, {}
    for name, a, w in zip(NAMES, got, want):
        if w is None:
            continue
        scale = max(float(w.abs().max()), 1e-3 * top)
        errs[name] = float((a.float() - w.float()).abs().max()) / scale
        tols[name] = 2e-2 if rounded.get(name) == torch.bfloat16 else 1e-4
    return errs, tols


def main() -> int:
    cases = [ast.literal_eval(a) for a in sys.argv[1:]] or CASES
    lib = Lib(build())
    ok = True
    for case in cases:
        t0 = time.perf_counter()
        errs, tols = run_case(lib, *case)
        good = all(math.isfinite(e) and e <= tols[k] for k, e in errs.items())
        ok &= good
        print(f"{'ok ' if good else 'BAD'} {case}: " + " ".join(
                  f"{k} {e:.2e}" for k, e in errs.items())
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
