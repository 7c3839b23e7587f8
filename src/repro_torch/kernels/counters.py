"""The kernels' launch counters, exact under threads.

The StreamFlow engine runs a workflow's invocations on a pool of threads,
so several threads can launch kernels at once, and a bare ``+=`` on a
module global can lose a count between its read and its write.  Each
wrapper counts its launch through :func:`bump`, which takes one lock.
"""
from __future__ import annotations

import threading
from typing import Optional

_LOCK = threading.Lock()


def bump(namespace: dict, total: str, by_route: Optional[dict] = None,
         route: Optional[str] = None) -> None:
    """Add one to ``namespace[total]`` (a kernel module's ``globals()``)
    and, given ``by_route``, to ``by_route[route]``, under one lock."""
    with _LOCK:
        namespace[total] += 1
        if by_route is not None:
            by_route[route] += 1
