"""Build the port's CUDA kernels into one shared library and load it.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` is compiled by one ``nvcc``
call for Hopper (``sm_90a``) into ``build/repro_torch/<hash>/libkernels.so``
at the repository root, where ``<hash>`` is a digest of the sources and the
flags, and loaded with ``ctypes``.  The sources have a plain C interface and
include no PyTorch header, so a build takes seconds.  The build happens at
first use (never at import); a library already built from the same sources
is reused.  Any failure to build or to load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_ROOT = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float     # nvcc's wall time; 0.0 when a cached build was reused
    log: str           # nvcc's output: ptxas registers, shared memory, spills
    cached: bool


def sources() -> List[Path]:
    return sorted(KERNELS_DIR.rglob("csrc/*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the CUDA "
                       "kernels are built on a machine with the CUDA toolkit")


def _digest(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(KERNELS_DIR.rglob("csrc/*.cuh"))
    for p in srcs + headers:
        h.update(str(p.relative_to(KERNELS_DIR)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the kernels unless a build of the same sources exists."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {KERNELS_DIR}")
    out_dir = BUILD_ROOT / _digest(srcs)
    lib = out_dir / "libkernels.so"
    if lib.is_file():
        return BuildInfo(lib, 0.0, "", cached=True)
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libkernels.{os.getpid()}.tmp.so"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {res.returncode}:\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)   # atomic: a concurrent builder sees all or nothing
    return BuildInfo(lib, seconds, log, cached=False)


_LIB: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_launch(err: int, what: str) -> None:
    """Raise if a kernel's launch function returned a CUDA error."""
    if err:
        msg = load_library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
