"""The traced window: ``torch.profiler`` over a few steps or rounds, reduced
to sums at once (no Chrome trace is written): each device operation's
time and launches by name, the seconds in which any operation ran on the
device, and the idle gaps between them, each named by what the host was
doing then (the innermost host operation open at the gap's middle)."""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch


# a kernel's name as the breakdown gives it: templated names run to
# thousands of characters, and their head tells them apart
NAME_CHARS = 160


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, List[float]]          # name -> [seconds, launches]
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def matching(self, pattern) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name the
        compiled regex ``pattern`` finds."""
        t, n = 0.0, 0
        for name, (s, c) in self.kernels.items():
            if pattern.search(name):
                t, n = t + s, n + int(c)
        return t, n

    def top_ops(self, n: int = 10) -> List[List]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:NAME_CHARS], s] for name, (s, _) in ops]

    def top_gaps(self, n: int = 10) -> List[List]:
        return [[name[:NAME_CHARS], s] for name, s in self.gaps[:n]]


class Window:
    """``with Window() as w: ...`` profiles the block; ``w.trace`` holds the
    sums afterwards.  The block starts and ends on a synchronised card."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = reduce(self._prof.events(), window)
        return False


# the harness's own ``record_function`` spans, which the profiler also
# puts on the device's timeline: no operation of the card
SPAN_PREFIX = "portbench."


def _is_device(ev) -> bool:
    return ev.device_type != torch.autograd.DeviceType.CPU


def reduce(events, window_s: float) -> Trace:
    """The sums of a profiler's events."""
    dev, host = [], []
    for ev in events:
        if not _is_device(ev):
            host.append(ev)
        elif not ev.name.startswith(SPAN_PREFIX):
            dev.append(ev)
    kernels: Dict[str, List[float]] = {}
    spans = []
    for ev in dev:
        s, e = ev.time_range.start, ev.time_range.end
        acc = kernels.setdefault(ev.name, [0.0, 0])
        acc[0] += (e - s) * 1e-6
        acc[1] += 1
        spans.append((s, e))
    if not spans:
        raise RuntimeError("the profiler recorded no device operation in "
                           "the traced window")
    spans.sort()
    merged = [list(spans[0])]
    for s, e in spans[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-6
    holes = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    return Trace(window_s, busy, kernels, _name_gaps(holes, host))


def _name_gaps(holes, host) -> List[Tuple[str, float]]:
    """Idle seconds by the innermost host operation open at each gap's
    middle (the one that started last among those open), longest first."""
    ops = sorted(((ev.time_range.start, ev.time_range.end, ev.name)
                  for ev in host), key=lambda o: o[0])
    starts = [o[0] for o in ops]
    by: Dict[str, float] = {}
    for a, b in holes:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host: between operations"
        # walk back to the latest-starting op that is still open
        j, seen = i, 0
        while j >= 0 and seen < 256:
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
            j -= 1
            seen += 1
        by[name] = by.get(name, 0.0) + (b - a) * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])
