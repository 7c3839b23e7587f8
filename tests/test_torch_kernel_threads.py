"""The kernels' build and launch counters under threads, as the StreamFlow
engine's pool runs invocations: one thread builds the library while the
others wait for it, and launches made by many threads at once are all
counted.  On the CPU: ``build`` and the C launch functions are stubbed, the
recording paths are the wrappers' own."""
import contextlib
import sys
import threading
import time
import types

import pytest
import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.mlstm_scan import kernel as ml
from repro_torch.kernels.moe_gmm import kernel as gmm
from repro_torch.kernels.rglru_scan import kernel as rg

THREADS, EACH = 16, 1000


def _together(n, fn, timeout=120.0):
    """Run ``fn(i)`` on ``n`` threads released at once, the interpreter
    switching threads every microsecond; their results."""
    barrier = threading.Barrier(n)
    out = [None] * n
    errors = []

    def work(i):
        try:
            barrier.wait()
            out[i] = fn(i)
        except BaseException as e:       # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    assert not errors, errors
    return out


def test_load_library_builds_once_under_threads(monkeypatch, tmp_path):
    calls = []

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.05)                 # the window an unlocked check leaves
        return build.BuildInfo(tmp_path / "libkernels.so", 0.05, "", False)

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.repro_cuda_error_string = types.SimpleNamespace()

    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "build", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    libs = _together(8, lambda i: build.load_library())
    assert len(calls) == 1
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].path == str(tmp_path / "libkernels.so")
    assert build.load_library() is libs[0] and len(calls) == 1


class _Yielding(dict):
    """A dict whose reads let another thread run before the write that
    follows them: a read-modify-write without a lock loses counts."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_bump_is_exact_under_threads():
    ns = _Yielding(N=0)
    by_route = _Yielding(a=0, b=0)
    _together(THREADS, lambda i: [
        counters.bump(ns, "N", by_route, "ab"[j % 2]) for j in range(EACH)])
    assert ns["N"] == THREADS * EACH
    assert by_route == {"a": THREADS * EACH // 2, "b": THREADS * EACH // 2}


@pytest.fixture
def stubbed_launches(monkeypatch):
    """Every wrapper's C function returns success at once; the device
    context and stream are the host's; counters start at 0."""
    ok = lambda *args: 0                 # noqa: E731
    for module in (fa, gmm, rg, ml):
        monkeypatch.setattr(module, "_kernel_fn", lambda: ok)
        if hasattr(module, "_bwd_kernel_fn"):
            monkeypatch.setattr(module, "_bwd_kernel_fn", lambda: ok)
        module.reset_launches()
    monkeypatch.setattr(rg, "bwd_workspace_bytes", lambda *a: 16)
    monkeypatch.setattr(ml, "workspace_bytes", lambda *a: 16)
    monkeypatch.setattr(ml, "bwd_workspace_bytes", lambda *a: 16)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    yield
    for module in (fa, gmm, rg, ml):
        module.reset_launches()


def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


def _flash(i):
    q = _t(1, 2, 1, 8)
    fa.launch(q, q, q, _t(1, 2, 1, 8), causal=True, window=0)


def _flash_bwd(i):
    q = _t(1, 2, 1, 8)
    fa.launch_bwd(q, q, q, q, q, _t(1, 1, 2), _t(1, 1, 2), _t(1, 2, 1, 8),
                  _t(1, 2, 1, 8), _t(1, 2, 1, 8), causal=True, window=0,
                  scale=0.5)


def _gmm(i):
    xe = _t(2, 4, 8)
    gmm.launch(xe, _t(2, 8, 16), _t(2, 8, 16), _t(2, 16, 8), _t(2, 4, 16),
               _t(2, 4, 8), None, act="swiglu",
               route=("scalar_f32", "wgmma_bf16")[i % 2])


def _gmm_bwd(i):
    xe, w = _t(2, 4, 8), _t(2, 8, 16)
    gmm.launch_bwd(xe, w, w, _t(2, 16, 8), xe, _t(2, 4, 8), _t(2, 8, 16),
                   _t(2, 8, 16), _t(2, 16, 8), _t(3, 2, 4, 16), None,
                   act="swiglu", route=("scalar_f32", "wgmma_bf16")[i % 2])


def _rglru(i):
    x = _t(1, 3, 4)
    biases = (None, None) if i % 2 else (_t(4), _t(4))
    rg.launch(x, _t(4), x, x, *biases, None, x, _t(1, 4))


def _rglru_bwd(i):
    x = _t(1, 3, 4)
    rg.launch_bwd(x, _t(4), x, x, _t(4), _t(4), None, x, x, None, x, x, x,
                  _t(4), _t(4), _t(4), None)


def _mlstm(i):
    q = _t(1, 3, 1, 8)
    g = _t(1, 3, 1)
    ml.launch(q, q, q, g, g, None, q, _t(1, 1, 8, 8), _t(1, 1, 8),
              _t(1, 1), ("scalar_f32", "wgmma_bf16")[i % 2])


def _mlstm_bwd(i):
    q = _t(1, 3, 1, 8)
    g = _t(1, 3, 1)
    ml.launch_bwd(q, q, q, g, g, None, q, (g, g), q, q, q, q, g, g,
                  "scalar_f32")


# (recording path, its counter, the routes its calls alternate between)
PATHS = {
    "flash_attention": (_flash, lambda: fa.LAUNCHES,
                        lambda: fa.LAUNCHES_BY_ROUTE, ["scalar_f32"]),
    "flash_attention_bwd": (_flash_bwd, lambda: fa.BWD_LAUNCHES,
                            lambda: fa.BWD_LAUNCHES_BY_ROUTE,
                            ["scalar_f32"]),
    "moe_gmm": (_gmm, lambda: gmm.LAUNCHES, lambda: gmm.LAUNCHES_BY_ROUTE,
                ["scalar_f32", "wgmma_bf16"]),
    "moe_gmm_bwd": (_gmm_bwd, lambda: gmm.BWD_LAUNCHES,
                    lambda: gmm.BWD_LAUNCHES_BY_ROUTE,
                    ["scalar_f32", "wgmma_bf16"]),
    "rglru_scan": (_rglru, lambda: rg.LAUNCHES,
                   lambda: rg.LAUNCHES_BY_ROUTE, ["fused_bias", "gates"]),
    "rglru_scan_bwd": (_rglru_bwd, lambda: rg.BWD_LAUNCHES,
                       lambda: rg.BWD_LAUNCHES_BY_ROUTE, ["fused_bias"]),
    "mlstm_scan": (_mlstm, lambda: ml.LAUNCHES,
                   lambda: ml.LAUNCHES_BY_ROUTE,
                   ["scalar_f32", "wgmma_bf16"]),
    "mlstm_scan_bwd": (_mlstm_bwd, lambda: ml.BWD_LAUNCHES,
                       lambda: ml.BWD_LAUNCHES_BY_ROUTE, ["scalar_f32"]),
}


@pytest.mark.parametrize("name", sorted(PATHS))
def test_launch_counts_are_exact_under_threads(name, stubbed_launches):
    record, total, by_route, routes = PATHS[name]
    _together(THREADS, lambda i: [record(i * EACH + j) for j in range(EACH)])
    assert total() == THREADS * EACH
    if by_route is not None:
        want = {r: 0 for r in by_route()}
        for r in routes:
            want[r] = THREADS * EACH // len(routes)
        assert by_route() == want
