"""Rewrite the port's CUDA sources for g++ and build them into a shared
library that runs them on the CPU (the driver scripts beside this file).

Each source is rewritten: the inline PTX section of ``csrc/hopper.cuh``
replaced by ``ptx_standins.h``, the CUDA runtime by ``cuda_stub.h``,
dynamic shared memory by a NaN-filled buffer, static shared arrays by
``static`` locals (blocks run one at a time) and launches by
``emu_launch``.  The headers in a source's ``csrc/`` directory are
rewritten beside it."""
from __future__ import annotations

import hashlib
import pathlib
import re
import subprocess

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
OUT = ROOT / "build/cuda_emu"


def _stub(text: str) -> str:
    for inc in ("<cuda.h>", "<cuda_runtime.h>", "<cuda_bf16.h>",
                "<cuda_pipeline.h>"):
        text = re.sub(r"#include " + re.escape(inc) + r"[^\n]*",
                      '#include "cuda_stub.h"', text)
    return text


def _rewrite(text: str) -> str:
    text = _stub(text).replace('#include "../../csrc/hopper.cuh"',
                               '#include "hopper_emu.cuh"')
    text = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                  r"\1* \2 = (\1*)emu_smem();", text)
    text = text.replace("__shared__", "static")
    return re.sub(r"([\w:]+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\(",
                  r"emu_launch(\1, \2, ", text, flags=re.S)


def build(sources, name: str, root: pathlib.Path = ROOT,
          edit=None) -> pathlib.Path:
    """The emulated library of ``sources`` (paths under ``root``'s
    ``src/repro_torch/kernels``), with ``edit(text) -> text`` applied to
    every rewritten file first, if given."""
    kdir = root / "src/repro_torch/kernels"
    hdr = (kdir / "csrc/hopper.cuh").read_text()
    a = hdr.index("// ---- BEGIN INLINE PTX")
    b = hdr.index("// ---- END INLINE PTX")
    files = {"hopper_emu.cuh": _stub(hdr[:a] + '#include "ptx_standins.h"\n'
                                     + hdr[b:])}
    for rel in sources:
        src = kdir / rel
        files[src.with_suffix(".cpp").name] = _rewrite(src.read_text())
        for h in sorted(src.parent.glob("*.cuh")):
            files[h.name] = _rewrite(h.read_text())
    if edit is not None:
        files = {k: edit(v) for k, v in files.items()}
    # one directory per source text: a process that loads two builds
    # (dlopen keeps the first library of a path) gets both
    digest = hashlib.sha256("".join(k + v for k, v in sorted(
        files.items())).encode()).hexdigest()[:16]
    out = OUT / digest
    out.mkdir(parents=True, exist_ok=True)
    for k, v in files.items():
        (out / k).write_text(v)
    lib = out / f"lib{name}_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC",
                    "-pthread", "-w", "-I", str(HERE), "-I", str(out), "-o",
                    str(lib)] + [str(out / k) for k in sorted(files)
                                 if k.endswith(".cpp")], check=True)
    return lib
