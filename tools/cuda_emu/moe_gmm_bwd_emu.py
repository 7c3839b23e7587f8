#!/usr/bin/env python3
"""Run the expert FFN backward's CUDA source on the CPU, against its plain
version, to check the kernels' indexing without a card.

    python3 tools/cuda_emu/moe_gmm_bwd_emu.py              # every case, route
    python3 tools/cuda_emu/moe_gmm_bwd_emu.py wgmma_bf16   # one route's

``src/repro_torch/kernels/moe_gmm/csrc/moe_gmm_bwd.cu`` (with its header
``moe_gmm.cuh``) is rewritten for g++ into ``build/cuda_emu/<digest>/`` by
``emu_build.py`` and built into a shared library whose C entry point,
``repro_moe_gmm_ffn_bwd``, takes CPU tensors through ctypes.  One
``std::thread`` runs each CUDA thread, blocks one at a time, on a card of
three multiprocessors (``cuda_stub.h``'s ``EMU_SMS``), so that the wgmma
route's persistent CTAs walk several tiles and stages wrap around the
ring; shared memory, the workspace and every output start as NaN; a TMA
load copies its box with zero fill and the 128-byte swizzle; a ``wgmma``
computes its tile at issue from the descriptors (``wgmma_tt`` reads A
MN-major).  What it cannot check: that the descriptor and swizzle
encodings match the hardware's, timing, and races that the asynchronous
products would expose.

Each case is held against ``ref.reference_expert_ffn_bwd`` in float32 on
the same inputs, each gradient relative to the plain one's max |.|
(floored at 1e-3 of the largest), at the card tests' bars (2e-2 for bf16,
1e-4 for float32); dxe must be exactly 0 on the pad rows, which hold NaN
in x and dy in the cases marked so, and every gradient finite.
"""
from __future__ import annotations

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
from repro_torch.kernels.moe_gmm import kernel, ref  # noqa: E402

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
ROUTE_DTYPE = {"wgmma_bf16": torch.bfloat16, "wmma_bf16": torch.bfloat16,
               "scalar_f32": torch.float32}
# (E, C, d, f, act, gated, fills (None: every row live), NaN in the pads)
CASES = [
    (3, 130, 136, 72, "swiglu", True, [0, 65, 130], False),
    (6, 129, 64, 128, "geglu", True, [63, 64, 65, 127, 128, 129], True),
    (2, 200, 200, 64, "relu2", False, [127, 200], True),
    (3, 65, 72, 136, "gelu", False, None, False),
    (2, 40, 64, 64, "swiglu", True, [0, 17], True),
]


def build(root: pathlib.Path = ROOT) -> pathlib.Path:
    """The emulated library of ``root``'s backward source."""
    return emu_build.build(["moe_gmm/csrc/moe_gmm_bwd.cu"], "moe_gmm_bwd",
                           root)


def bwd_fn(lib: pathlib.Path):
    fn = ctypes.CDLL(str(lib)).repro_moe_gmm_ffn_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_case(fn, route, E, C, d, f, act, gated, fills, nan_pads, seed=0):
    """Each gradient's error over its plain max |.|, whether dxe is 0 on
    every pad row, and whether every gradient is finite."""
    dtype = ROUTE_DTYPE[route]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((E, C, d), generator=g)
    dy = torch.randn((E, C, d), generator=g)
    p = {"w1": torch.randn((E, d, f), generator=g) / math.sqrt(d),
         "w2": torch.randn((E, f, d), generator=g) / math.sqrt(f)}
    if gated:
        p["w3"] = torch.randn((E, d, f), generator=g) / math.sqrt(d)
    counts = None if fills is None else torch.tensor(fills, dtype=torch.int32)
    if counts is not None and nan_pads:
        pads = ~ref.live_rows(x, counts)
        x[pads] = float("nan")
        dy[pads] = float("nan")
    x, dy = x.to(dtype), dy.to(dtype)
    p = {k: w.to(dtype) for k, w in p.items()}
    nan = lambda t: torch.full_like(t, float("nan"))  # noqa: E731
    dx, dw1, dw2 = nan(x), nan(p["w1"]), nan(p["w2"])
    dw3 = nan(p["w3"]) if gated else None
    ws = torch.full((3 if gated else 2, E, C, f), float("nan"), dtype=dtype)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(x.data_ptr(), p["w1"].data_ptr(), ptr(p.get("w3")),
             p["w2"].data_ptr(), dy.data_ptr(), dx.data_ptr(),
             dw1.data_ptr(), ptr(dw3), dw2.data_ptr(), ws.data_ptr(),
             ptr(counts), E, C, d, f, kernel.ACT_CODE[act],
             kernel.ROUTES[route], None)
    if err:
        raise RuntimeError(f"launch refused: {err}")
    want = ref.reference_expert_ffn_bwd(
        x.float(), {k: w.float() for k, w in p.items()}, dy.float(), act,
        counts)
    got = [t for t in (dx, dw1, dw3, dw2) if t is not None]
    want = [t for t in want if t is not None]
    scales = [float(w.abs().max()) for w in want]
    floor = 1e-3 * max(scales)
    errs = [float((t.float() - w).abs().max()) / max(sc, floor)
            for t, w, sc in zip(got, want, scales)]
    zero_pads = counts is None or not dx[~ref.live_rows(x, counts)].any()
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    return errs, zero_pads, finite


def main() -> int:
    routes = sys.argv[1:] or list(ROUTE_DTYPE)
    fn = bwd_fn(build())
    ok = True
    for route in routes:
        for case in CASES:
            t0 = time.perf_counter()
            errs, zero_pads, finite = run_case(fn, route, *case)
            tol = TOL[ROUTE_DTYPE[route]]
            good = finite and zero_pads and all(e <= tol for e in errs)
            ok &= good
            names = ["dx", "dw1"] + (["dw3"] if case[5] else []) + ["dw2"]
            rels = " ".join(f"{n} {e:.2e}" for n, e in zip(names, errs))
            print(f"{'ok ' if good else 'BAD'} {route} {case[:6]} fills "
                  f"{case[6]}{' NaN pads' if case[7] else ''}: {rels}"
                  f"{'' if zero_pads else ' dx NOT 0 on pads'}"
                  f"{'' if finite else ' NOT finite'} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
