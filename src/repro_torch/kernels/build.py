"""Build the port's CUDA kernels into one shared library and load it.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` is compiled for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
the objects are linked into ``build/repro_torch/<hash>/libkernels.so`` at
the repository root, where ``<hash>`` is a digest of the sources and the
flags, and loaded with ``ctypes``.  The sources have a plain C interface and
include no PyTorch header, so a build takes as long as its largest source.
The build happens at first use (never at import); a library already built
from the same sources is reused.  Any failure to build or to load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional


KERNELS_DIR = Path(__file__).resolve().parent
BUILD_ROOT = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# one source into an object: the same flags, without -shared
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared")


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float     # the build's wall time, compiles and link; 0.0 when a
                       # cached build was reused
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
    tag = f"{os.getpid()}.tmp"
    objs = [out_dir / (str(p.relative_to(KERNELS_DIR)).replace(os.sep, "_")
                       + f".{tag}.o") for p in srcs]
    tmp = out_dir / f"libkernels.{tag}.so"
    t0 = time.perf_counter()
    # one nvcc per source, all at once: the build takes the longest one's
    # time rather than the sum
    cmds = [[nvcc, *COMPILE_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(outs)
    failed = [(cmd, out) for cmd, out, proc in zip(cmds, outs, procs)
              if proc.returncode != 0]
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            failed = [(cmd, res.stdout + res.stderr)]
    for o in objs:
        o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(cmd)}\n{out}" for cmd, out in failed))
    os.replace(tmp, lib)   # atomic: a concurrent builder sees all or nothing
    return BuildInfo(lib, seconds, log, cached=False)


_LIB: Optional[ctypes.CDLL] = None
# the StreamFlow engine's threads can reach a first launch together: one
# builds, the others wait for its library
_LIB_LOCK = threading.Lock()


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB
    with _LIB_LOCK:
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
