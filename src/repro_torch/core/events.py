"""Typed run events + the bounded live event stream (beyond-paper).

The paper's driver is observable only post-hoc: ``Executor.run`` returns a
``RunResult`` whose ``JobEvent`` log exists after the workflow ended.  A
long-lived multi-tenant service (GA4GH TES-style submit/status/cancel)
needs the opposite — a *live*, typed event stream a client can follow
while the run executes.  This module provides:

  * the event taxonomy — small mutable dataclasses stamped with a
    monotonic per-stream sequence number and wall time at emission:

      WorkflowStarted          run admitted by the loop (or resumed)
      InvocationStateChanged   fireable -> scheduled -> running ->
                               completed/failed/cancelled, with site
      TokenAvailable           an output token registered (port + tag)
      TransferRouted           the PR-4 planner moved bytes (route, kind)
      WorkflowCompleted        terminal: carries the RunResult
      WorkflowFailed           terminal: the raising error
      WorkflowCancelled        terminal: cooperative cancel landed

  * ``EventSink`` — a bounded queue between the executor loops (producers)
    and the consumer iterating the stream.  ``emit`` BLOCKS when the
    buffer is full: a lagging consumer back-pressures the run instead of
    losing events.  A consumer that abandons the stream (closes the
    iterator) flips the sink to drop mode so the run can still finish.

  * ``EventStream`` — ties a sink to an executor and drives the run on a
    background thread, eagerly (the service admits runs whether or not
    anyone is watching); iterate it for the events, ``result()`` joins
    and returns/raises what ``run()`` would have.

Resumed runs (``Executor.resume``) replay journaled history through the
same sink as synthetic events (``replayed=True``) before going live, so a
client attaching after a crash still sees the whole story in order.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


class RunCancelled(RuntimeError):
    """Raised out of ``Executor._execute`` when a cooperative cancel
    lands; the service maps it to the TES ``CANCELED`` terminal state."""


# --------------------------------------------------------------- taxonomy
@dataclass
class WorkflowEvent:
    """Base: every event is stamped by the sink at emission."""
    seq: int = field(default=-1, init=False)      # per-stream, monotonic
    t: float = field(default=0.0, init=False)     # wall time at emit
    replayed: bool = field(default=False, init=False)  # synthetic (resume)


@dataclass
class WorkflowStarted(WorkflowEvent):
    workflow: str = ""
    invocations: int = 0
    resumed: bool = False


@dataclass
class InvocationStateChanged(WorkflowEvent):
    path: str = ""
    state: str = ""            # fireable|scheduled|running|completed|
    #                            failed|cancelled
    model: Optional[str] = None
    resource: Optional[str] = None
    attempt: int = 0
    speculative: bool = False
    error: Optional[str] = None
    # provenance: True when the invocation was satisfied from the
    # cross-run cache instead of executing — timelines stay honest
    memoized: bool = False


@dataclass
class TokenAvailable(WorkflowEvent):
    token: str = ""
    port: str = ""
    tag: Tuple[int, ...] = ()
    model: Optional[str] = None
    resource: Optional[str] = None


@dataclass
class TransferRouted(WorkflowEvent):
    token: str = ""
    kind: str = ""             # elided|staging|intra-model|direct|two-step
    route: str = ""            # planner hop description, e.g. "hpc->cloud"
    src: Optional[str] = None
    dst: str = ""
    bytes: int = 0
    seconds: float = 0.0


@dataclass
class WorkflowCompleted(WorkflowEvent):
    workflow: str = ""
    outputs: Dict[str, Any] = field(default_factory=dict)
    result: Any = None         # the RunResult run() would have returned


@dataclass
class WorkflowFailed(WorkflowEvent):
    workflow: str = ""
    error: str = ""
    error_type: str = ""


@dataclass
class WorkflowCancelled(WorkflowEvent):
    workflow: str = ""
    pending: List[str] = field(default_factory=list)  # never-completed paths


TERMINAL_EVENTS = (WorkflowCompleted, WorkflowFailed, WorkflowCancelled)


# ------------------------------------------------------------------- sink
class EventSink:
    """Bounded producer/consumer channel with backpressure.

    ``emit`` blocks while the buffer is full — the executor loops slow
    down to the consumer's pace rather than dropping events.  ``close``
    ends the stream (consumer's iterator raises StopIteration after
    draining).  ``abandon`` is the consumer-side escape hatch: once the
    consumer walks away, producers stop blocking and events are dropped
    on the floor so the run itself can complete.
    """

    _SENTINEL = object()

    def __init__(self, maxsize: int = 256):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, maxsize))
        self._seq = itertools.count()                 # lock: _lock
        self._abandoned = threading.Event()
        self._closed = False                          # lock: _lock
        # held by ``emit`` from an event's stamp to its enqueue: producers
        # blocked on a full buffer otherwise enqueue in whichever order a
        # slot frees for them, and the consumer sees the sequence out of
        # order; ``close`` so waits for an emit in flight
        self._lock = threading.Lock()

    def emit(self, ev: WorkflowEvent):
        with self._lock:
            ev.seq = next(self._seq)
            ev.t = time.time()
            while not self._abandoned.is_set():
                try:
                    self._q.put(ev, timeout=0.05)
                    return
                except queue.Full:
                    continue

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
        while not self._abandoned.is_set():
            try:
                self._q.put(self._SENTINEL, timeout=0.05)
                return
            except queue.Full:
                continue

    def abandon(self):
        """Consumer gone: unblock producers forever and drain the queue."""
        self._abandoned.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def events(self):
        """Single-consumer generator over the stream."""
        try:
            while True:
                item = self._q.get()
                if item is self._SENTINEL:
                    return
                yield item
        finally:
            self.abandon()


# ----------------------------------------------------------------- stream
class EventStream:
    """An eagerly-running workflow execution observable as an event
    iterator.  Construction attaches the sink to the executor and starts
    the run on a daemon thread — iteration is optional (a service admits
    runs whether or not a client watches; an unwatched stream's producer
    blocks only once the buffer fills, so pass a large ``buffer`` or
    iterate if the run is long)."""

    def __init__(self, executor, target: Callable[[], Any], *,
                 buffer: int = 256, sink: Optional[EventSink] = None):
        self.sink = sink if sink is not None else EventSink(buffer)
        self._executor = executor
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        self._callbacks: List[Callable[["EventStream"], None]] = []
        self._cb_lock = threading.Lock()
        executor._sink = self.sink
        executor.data.event_sink = self.sink
        self._thread = threading.Thread(
            target=self._run, args=(target,), daemon=True,
            name="sf-run-stream")
        self._thread.start()

    def _run(self, target):
        try:
            self._result = target()
        except BaseException as e:                # noqa: BLE001 — relayed
            self._error = e
        finally:
            self._executor._sink = None
            self._executor.data.event_sink = None
            self.sink.close()
            self._done.set()
            with self._cb_lock:
                callbacks, self._callbacks = self._callbacks, []
            for cb in callbacks:
                cb(self)

    def __iter__(self):
        return self.sink.events()

    def add_done_callback(self, fn: Callable[["EventStream"], None]):
        with self._cb_lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """Join the run: returns the RunResult or re-raises its error."""
        if not self._done.wait(timeout):
            raise TimeoutError("run still executing")
        if self._error is not None:
            raise self._error
        return self._result
