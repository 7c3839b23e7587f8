"""The port's live event stream (``repro_torch.core.events``) under a
lagging consumer: the twin of ``tests/test_events.py``'s
``test_lagging_consumer_loses_nothing`` on the port's engine, and the
ordering it rests on.

The reference's ``EventSink.emit`` stamps an event's sequence number
under a lock and enqueues it after releasing it.  With a full buffer,
the executor's threads then wait in ``put`` together, each for 50 ms at
a time; one that times out waits again behind the others, and whichever
a slot frees for first enqueues first: the consumer sees every event,
but not always in sequence order (the JAX test fails so now and then
under load, when the consumer lags by more than 50 ms).  The port stamps
and enqueues under one lock, so the stream is in sequence order by
construction.  Every wait here has a time limit."""
import sys
import threading
import time

from repro_torch.configs import recovery_demo
from repro_torch.core import (EventSink, FaultConfig, InvocationStateChanged,
                              ModelSpec, StreamFlowExecutor,
                              WorkflowCompleted, WorkflowEvent)
from repro_torch.core.streamflow_file import Binding

SITE = {"site": ModelSpec("site", "local",
                          {"services": {"svc": {"replicas": 4}}})}
BIND = [Binding("/", "site", "svc")]
WAIT_S = 60.0


def _consume(events, lag_s):
    """Each event of ``events`` into a list, ``lag_s`` apart, on a thread
    joined within WAIT_S."""
    got = []

    def drain():
        for ev in events:
            time.sleep(lag_s)
            got.append(ev)
    t = threading.Thread(target=drain, daemon=True)
    t.start()
    t.join(WAIT_S)
    assert not t.is_alive(), f"the stream did not end within {WAIT_S} s"
    return got


def test_lagging_consumer_loses_nothing():
    """buffer=2 with a consumer slower than the producer: emit() blocks
    (it does not drop), and the whole story arrives in sequence order."""
    wf = recovery_demo.build_workflow(n_blocks=3, block_rows=32, rounds=3)
    ex = StreamFlowExecutor(SITE, fault=FaultConfig(speculative=False))
    es = ex.run_stream(wf, BIND, {"seed": 3}, buffer=2)
    events = _consume(es, 0.002)
    assert isinstance(events[-1], WorkflowCompleted)
    assert [e.seq for e in events] == list(range(len(events)))
    completed = [e for e in events if isinstance(e, InvocationStateChanged)
                 and e.state == "completed"]
    assert len(completed) == len(wf.steps)
    assert "combined" in es.result(timeout=WAIT_S).outputs


def test_producers_blocked_on_a_full_sink_enqueue_in_sequence_order():
    """Four threads emit 15 events each into a sink of one slot while the
    consumer takes one every 30 ms, so that each producer waits past
    ``put``'s 50 ms: the consumer receives 60 events, numbered 0, 1, 2,
    ... in the order it receives them (the reference's ``emit`` fails
    this).  The interpreter switches threads every microsecond meanwhile,
    so a producer is preempted between any two steps of ``emit``."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        events = _emit_from_four_producers()
    finally:
        sys.setswitchinterval(interval)
    assert [e.seq for e in events] == list(range(60))


def _emit_from_four_producers():
    sink = EventSink(maxsize=1)
    producers = [threading.Thread(
        target=lambda: [sink.emit(WorkflowEvent()) for _ in range(15)],
        daemon=True) for _ in range(4)]

    def close_after_producers():
        for p in producers:
            p.join(WAIT_S)
        sink.close()
    for p in producers:
        p.start()
    closer = threading.Thread(target=close_after_producers, daemon=True)
    closer.start()
    events = _consume(sink.events(), 0.03)
    closer.join(WAIT_S)
    assert not closer.is_alive() and not any(p.is_alive() for p in producers)
    return events
