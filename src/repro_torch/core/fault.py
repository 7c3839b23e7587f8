"""Fault-tolerance knobs + helpers: retry/backoff, heartbeat monitoring, and
straggler speculation (beyond-paper, DAGMan-style, but designed to fit the
paper's FCFS loop: a speculative twin is just another job whose completion
races the original's).

Under the pipelined executor's concurrent dispatch, backoff is *deferred*
rather than slept: the executor keeps a retry deadline per failed job and
keeps dispatching unrelated ready work in the meantime, so one flaky site
never stalls the whole queue."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class FaultConfig:
    max_retries: int = 2
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    heartbeat_interval_s: float = 0.25
    speculative: bool = True
    straggler_factor: float = 3.0
    straggler_min_samples: int = 2
    straggler_min_elapsed_s: float = 0.05

    @classmethod
    def from_dict(cls, d: dict) -> "FaultConfig":
        return cls(**{k: v for k, v in d.items()
                      if k in cls.__dataclass_fields__})


class DurationTracker:
    """Per-service completed-duration history for straggler detection."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hist: Dict[str, List[float]] = {}

    def record(self, service: str, seconds: float):
        with self._lock:
            self._hist.setdefault(service, []).append(seconds)

    def median(self, service: str) -> Optional[float]:
        with self._lock:
            xs = sorted(self._hist.get(service, []))
        if not xs:
            return None
        return xs[len(xs) // 2]

    def count(self, service: str) -> int:
        with self._lock:
            return len(self._hist.get(service, []))

    def is_straggler(self, service: str, elapsed: float,
                     cfg: FaultConfig) -> bool:
        if elapsed < cfg.straggler_min_elapsed_s:
            return False
        if self.count(service) < cfg.straggler_min_samples:
            return False
        med = self.median(service)
        return med is not None and elapsed > cfg.straggler_factor * med


def backoff_delays(cfg: FaultConfig):
    d = cfg.backoff_s
    for _ in range(cfg.max_retries):
        yield d
        d *= cfg.backoff_mult
