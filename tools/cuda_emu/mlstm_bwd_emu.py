#!/usr/bin/env python3
"""Run the mLSTM backward's wgmma_bf16 route (and the forward's, which
writes its inputs) on the CPU, against the plain backward, to check the
kernels' indexing without a card.

    python3 tools/cuda_emu/mlstm_bwd_emu.py            # the default cases
    python3 tools/cuda_emu/mlstm_bwd_emu.py "(1, 200, 2, 64, True, False)"

Each case is (B, S, H, Dh, with an initial state, clamp[, segmented]):
``clamp`` lowers the input gates by 8 so that the denominator's floor
takes most rows; ``segmented`` builds the sources with a state budget of
one chunk, so that every chunk is a segment of its own and the states are
carried between segments.

``csrc/mlstm_scan.cu`` and ``csrc/mlstm_scan_bwd.cu`` (with
``mlstm_wgmma.cuh``, the passes they share) are rewritten for g++ by
``emu_build.py`` and built into one shared library; its C entry points
take CPU tensors through ctypes.  The forward runs on its wgmma route with
its row statistics; the backward takes them, as the autograd function
does, and is held against ``ref.reference_mlstm_bwd`` on the forward's
own h and statistics: bf16 dq, dk, dv at 2e-2 of each plain gradient's
max |.| and dig, dfg at 1e-4 (each floored at 1e-3 of its group's
largest), as the card tests hold them.  The workspace and the outputs
start as NaN, so a read of what no pass wrote shows.  What it cannot
check: the descriptor and swizzle encodings against the hardware's,
timing, and races the asynchronous products would expose.
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
from repro_torch.kernels.mlstm_scan import ops, ref  # noqa: E402

WGMMA = 2   # the C functions' route code of wgmma_bf16
TOL = {"dq": 2e-2, "dk": 2e-2, "dv": 2e-2, "dig": 1e-4, "dfg": 1e-4}
CASES = [(2, 1, 2, 64, False, False), (1, 127, 2, 64, False, False),
         (1, 129, 2, 64, True, False), (2, 200, 2, 64, False, True),
         (1, 136, 2, 64, True, False), (1, 200, 1, 192, True, False),
         (1, 129, 1, 192, False, False), (1, 257, 2, 64, True, False, True),
         (1, 200, 1, 192, False, False, True)]


def budget_of_one_chunk(text: str) -> str:
    return text.replace("constexpr long long STATE_BUDGET = 1LL << 30;",
                        "constexpr long long STATE_BUDGET = 1;")


def build(root: pathlib.Path = ROOT, segmented: bool = False):
    """The emulated library of ``root``'s two mLSTM sources."""
    return emu_build.build(["mlstm_scan/csrc/mlstm_scan.cu",
                            "mlstm_scan/csrc/mlstm_scan_bwd.cu"],
                           "mlstm_seg" if segmented else "mlstm", root,
                           edit=budget_of_one_chunk if segmented else None)


class Lib:
    def __init__(self, path: pathlib.Path):
        lib = ctypes.CDLL(str(path))
        self.fwd = lib.repro_mlstm_scan
        self.fwd.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_void_p]
        self.bwd = lib.repro_mlstm_scan_bwd
        self.bwd.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + \
            [ctypes.c_float, ctypes.c_void_p]
        self.fwd_ws = lib.repro_mlstm_scan_workspace_bytes
        self.fwd_ws.argtypes = [ctypes.c_int] * 5
        self.fwd_ws.restype = ctypes.c_longlong
        self.bwd_ws = lib.repro_mlstm_scan_bwd_workspace_bytes
        self.bwd_ws.argtypes = [ctypes.c_int] * 5
        self.bwd_ws.restype = ctypes.c_longlong


def _nan_ws(nbytes):
    return torch.full((nbytes,), 0xFF, dtype=torch.uint8)


def _ptr(t):
    return None if t is None else t.data_ptr()


def run_case(lib, B, S, H, Dh, with_init, clamp, seed=0):
    """{gradient: error relative to the plain one's scale}."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((B, S, H, Dh), generator=g).bfloat16()
               for _ in range(3))
    ig = torch.randn((B, S, H), generator=g) - (8.0 if clamp else 0.0)
    fg = 3.0 + torch.randn((B, S, H), generator=g)
    dh = torch.randn((B, S, H, Dh), generator=g)
    init = (torch.randn((B, H, Dh, Dh), generator=g),
            torch.randn((B, H, Dh), generator=g),
            torch.randn((B, H), generator=g)) if with_init else None
    nan = float("nan")
    h = torch.full((B, S, H, Dh), nan)
    C, n, m = (torch.full(s, nan) for s in ((B, H, Dh, Dh), (B, H, Dh),
                                            (B, H)))
    mstat, dstat = torch.full((B, S, H), nan), torch.full((B, S, H), nan)
    ws = _nan_ws(lib.fwd_ws(B, S, H, Dh, WGMMA))
    i3 = (None,) * 3 if init is None else tuple(t.data_ptr() for t in init)
    err = lib.fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
                  fg.data_ptr(), *i3, ws.data_ptr(), h.data_ptr(),
                  C.data_ptr(), n.data_ptr(), m.data_ptr(), mstat.data_ptr(),
                  dstat.data_ptr(), B, S, H, Dh, WGMMA, math.sqrt(Dh), None)
    if err:
        raise RuntimeError(f"forward refused: {err}")
    # the forward's final m is the chain's, which its last row's
    # stabiliser must equal bit for bit
    assert torch.equal(m, mstat[:, -1]), "chain m != last row's m_t"
    dq, dk, dv = (torch.full((B, S, H, Dh), nan).bfloat16() for _ in range(3))
    dig, rows = torch.full((B, S, H), nan), torch.full((B, S, H), nan)
    ws = _nan_ws(lib.bwd_ws(B, S, H, Dh, WGMMA))
    err = lib.bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), ig.data_ptr(),
                  fg.data_ptr(), *i3, h.data_ptr(), dh.data_ptr(),
                  mstat.data_ptr(), dstat.data_ptr(), ws.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  dig.data_ptr(), rows.data_ptr(), B, S, H, Dh, WGMMA,
                  math.sqrt(Dh), None)
    if err:
        raise RuntimeError(f"backward refused: {err}")
    got = (dq, dk, dv, dig, ops.fg_grad(fg, dig, rows))
    want = ref.reference_mlstm_bwd(q, k, v, ig, fg, h, (mstat, dstat), dh,
                                   init_state=init)
    errs = {}
    for lo, hi in ((0, 3), (3, 5)):
        top = max(float(w.abs().max()) for w in want[lo:hi])
        for name, a, w in zip(("dq", "dk", "dv", "dig", "dfg")[lo:hi],
                              got[lo:hi], want[lo:hi]):
            scale = top if S == 1 and name in ("dq", "dk", "dfg") else \
                max(float(w.abs().max()), 1e-3 * top)
            errs[name] = float((a.float() - w).abs().max()) / scale
    return errs


def main() -> int:
    cases = [ast.literal_eval(a) for a in sys.argv[1:]] or CASES
    libs = {}
    ok = True
    for case in cases:
        segmented = len(case) > 6 and case[6]
        if segmented not in libs:
            libs[segmented] = Lib(build(segmented=segmented))
        t0 = time.perf_counter()
        errs = run_case(libs[segmented], *case[:6])
        good = all(math.isfinite(e) and e <= TOL[k] for k, e in errs.items())
        ok &= good
        print(f"{'ok ' if good else 'BAD'} {case}: " + " ".join(
            f"{k} {e:.2e}" for k, e in errs.items())
            + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
