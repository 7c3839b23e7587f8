#!/usr/bin/env python3
"""Run the flash backward's CUDA source on the CPU, against its plain
version, to check the kernels' indexing without a card.

    python3 tools/cuda_emu/flash_bwd_emu.py            # the default cases
    python3 tools/cuda_emu/flash_bwd_emu.py "(1, 200, 4, 1, 128, True, 0, 2)"

Each case is (B, S, H, KH, Dh, causal, window[, splits]) with Dh one of the
kernel's (64, 120, 128, 256); without splits, the wrapper's rule for a card
of 4 multiprocessors picks them, so that small shapes split too.

``src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu`` is
rewritten for g++ into ``build/cuda_emu/<digest>/`` by ``emu_build.py`` (the
inline PTX section of ``csrc/hopper.cuh`` replaced by ``ptx_standins.h``,
the CUDA runtime by ``cuda_stub.h``, launches by ``emu_launch``) and built
into a shared library, whose C entry point takes CPU tensors through
ctypes.  One
``std::thread`` runs each CUDA thread, blocks one at a time; shared memory
starts as NaN; mbarriers count arrivals and TMA bytes; a TMA load copies
its box with zero fill and the 128-byte swizzle; a ``wgmma`` computes its
tile at issue from the descriptors, in the accumulator's fragment layout,
gathering register A operands across the warpgroup.  What it cannot check:
that the descriptor and swizzle encodings match the hardware's, timing,
and races that the asynchronous products would expose (the stand-ins
complete at once).  bf16 gradients are held at 2e-2 of each plain
gradient's max |.|, as the card tests hold them.
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
from repro_torch.kernels.flash_attention import kernel, ref  # noqa: E402

TOL = 2e-2
SMS = 4
CASES = [(2, 1, 8, 2, 64, True, 0), (2, 63, 8, 8, 120, True, 0),
         (2, 65, 6, 1, 256, True, 32), (2, 63, 4, 4, 120, False, 0),
         (1, 200, 4, 2, 64, False, 40), (1, 136, 4, 2, 128, True, 0),
         (2, 129, 3, 3, 64, True, 0), (1, 127, 2, 1, 256, False, 0),
         (1, 300, 6, 2, 64, True, 100), (1, 257, 4, 1, 256, True, 64),
         (1, 130, 6, 1, 128, True, 0, 3), (1, 130, 6, 3, 64, True, 1),
         (1, 130, 16, 1, 64, True, 0, 5), (1, 100, 8, 1, 120, True, 0, 8)]


def build(root: pathlib.Path = ROOT) -> pathlib.Path:
    """The emulated library of ``root``'s backward source."""
    return emu_build.build(["flash_attention/csrc/flash_attention_bwd.cu"],
                           "flash_bwd", root)


def bwd_fn(lib: pathlib.Path):
    fn = ctypes.CDLL(str(lib)).repro_flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def run_case(fn, B, S, H, KH, Dh, causal, window, splits=None, seed=0):
    """Each gradient's error over its plain max |.| (floored at 1e-3 of
    the largest; dq and dk against the largest where every query sees one
    key, as the card tests hold them)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, h, Dh), generator=g).bfloat16()
                   for h in (H, KH, KH, H))
    o = ref.reference_attention(q.float(), k.float(), v.float(),
                                causal=causal, window=window)
    o = o.bfloat16().contiguous()
    lse = ref.reference_attention_lse(q.float(), k.float(), causal=causal,
                                      window=window).contiguous()
    dsum = torch.full_like(lse, float("nan"))
    grads = [torch.full(t.shape, float("nan")).bfloat16() for t in (q, k, v)]
    if splits is None:
        splits = kernel.bwd_splits(B, S, H, KH, Dh, SMS)
    part = None if splits == 1 else torch.full(
        (2, splits, B, S, KH, Dh), float("nan"))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
             *(t.data_ptr() for t in grads),
             None if part is None else part.data_ptr(), B, S, H, KH, Dh,
             int(causal), window, 1, splits, 1.0 / math.sqrt(Dh), None)
    if err:
        raise RuntimeError(f"launch refused: {err}")
    want = ref.reference_attention_bwd(q.float(), k.float(), v.float(),
                                       o.float(), lse, do.float(),
                                       causal=causal, window=window)
    scales = [float(w.abs().max()) for w in want]
    floor = 1e-3 * max(scales)
    if S == 1 or window == 1:
        scales[0] = scales[1] = max(scales)
    return splits, [float((t.float() - w).abs().max()) / max(sc, floor)
                    for t, w, sc in zip(grads, want, scales)]


def main() -> int:
    cases = [ast.literal_eval(a) for a in sys.argv[1:]] or CASES
    fn = bwd_fn(build())
    ok = True
    for case in cases:
        t0 = time.perf_counter()
        splits, errs = run_case(fn, *case)
        good = all(math.isfinite(e) and e <= TOL for e in errs)
        ok &= good
        print(f"{'ok ' if good else 'BAD'} {case} splits={splits}: dq "
              f"{errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
