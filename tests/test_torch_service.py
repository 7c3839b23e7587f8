"""The port's multi-tenant WorkflowService (``repro_torch.core.service``):
the twins of the 18 tests of ``tests/test_service.py`` on the port's
engine, ``repro_torch.configs.recovery_demo`` and the port's §5 scatter
workflow, on the CPU.

TES-style submit, status, cancel and list; fair share, priority and
quotas at admission; deployment pooling; cancellation (a queued run never
deploys, a running one journals a resumable ``cancelled`` state); and the
deployment manager's races.  Every wait has a timeout of its own: a run is
held open by a gate that the test releases, never by a sleep, and a
stream is drained on a thread that must end within its limit.
"""
import threading
import time

import pytest

from repro_torch import pipeline
from repro_torch.configs import recovery_demo
from repro_torch.core import (CANCELED, COMPLETE, EXECUTOR_ERROR, QUEUED,
                              RUNNING, CheckpointConfig, DeploymentManager,
                              ExecutionJournal, FaultConfig, ModelSpec,
                              RunCancelled, ServiceConfig,
                              StreamFlowExecutor, TenantPolicy,
                              WorkflowCompleted, WorkflowService,
                              load_streamflow_file)
from repro_torch.core.service import ServiceError, UnknownRunError
from repro_torch.core.streamflow_file import Binding
from repro_torch.core.workflow import Step, Workflow

MODELS = {"site": ModelSpec("site", "local",
                            {"services": {"svc": {"replicas": 4}}})}
BIND = [Binding("/", "site", "svc")]

# a gated run blocks on its named Event until the test releases it
GATES = {}


def _gate(name):
    GATES[name] = threading.Event()
    return name


def _gated_wf(gate_key):
    wf = Workflow(f"gated-{gate_key}")

    def fn(inputs, ctx):
        GATES[gate_key].wait(timeout=30)
        return {"out": inputs["x"] + 1}
    wf.add_step(Step("/work", fn, {"x": "x"}, ("out",)))
    return wf


def _quick_wf():
    return recovery_demo.build_workflow(n_blocks=2, block_rows=32, rounds=2)


def _service(cfg=None, **kw):
    kw.setdefault("fault", FaultConfig(speculative=False))
    kw.setdefault("deadlock_timeout_s", 0.5)
    return WorkflowService(MODELS, service=cfg, **kw)


def _wait_state(svc, rid, state, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if svc.status(rid).state == state:
            return
        time.sleep(0.01)
    raise AssertionError(
        f"{rid} never reached {state} (is {svc.status(rid).state})")


def _drain_stream(events, timeout=30.0):
    """Every event of a stream, read on a thread that must finish within
    ``timeout``."""
    got = []
    reader = threading.Thread(target=lambda: got.extend(events),
                              daemon=True)
    reader.start()
    reader.join(timeout)
    assert not reader.is_alive(), f"the stream did not end in {timeout} s"
    return got


def test_the_public_surface_is_the_jax_packages():
    import repro.core as J
    import repro_torch.core as T
    assert T.__all__ == J.__all__
    assert (T.QUEUED, T.RUNNING, T.COMPLETE, T.EXECUTOR_ERROR, T.CANCELED,
            T.TERMINAL_STATES) == (J.QUEUED, J.RUNNING, J.COMPLETE,
                                   J.EXECUTOR_ERROR, J.CANCELED,
                                   J.TERMINAL_STATES)


# ----------------------------------------------------------------- lifecycle

def test_submit_status_wait_complete():
    svc = _service()
    rid = svc.submit(_quick_wf(), BIND, {"seed": 7})
    info = svc.wait(rid, timeout=30)
    assert info.state == COMPLETE and info.terminal
    assert info.started_at is not None and info.finished_at is not None
    assert "combined" in svc.result(rid).outputs
    svc.close(timeout=30)


def test_failed_run_is_executor_error():
    wf = Workflow("boom")

    def fn(inputs, ctx):
        raise ValueError("boom")
    wf.add_step(Step("/bad", fn, {"x": "x"}, ("y",)))
    svc = _service(fault=FaultConfig(max_retries=0, speculative=False))
    rid = svc.submit(wf, BIND, {"x": 1})
    assert svc.wait(rid, timeout=30).state == EXECUTOR_ERROR
    with pytest.raises(Exception):
        svc.result(rid, timeout=30)
    svc.close(cancel_pending=False, timeout=30)


def test_list_runs_filters_and_unknown_id():
    svc = _service()
    r1 = svc.submit(_quick_wf(), BIND, {"seed": 1}, tenant="alice")
    r2 = svc.submit(_quick_wf(), BIND, {"seed": 2}, tenant="bob")
    svc.drain(timeout=60)
    assert [i.id for i in svc.list_runs()] == [r1, r2]
    assert [i.id for i in svc.list_runs(tenant="bob")] == [r2]
    assert [i.id for i in svc.list_runs(state=COMPLETE)] == [r1, r2]
    with pytest.raises(UnknownRunError):
        svc.status("nope")
    with pytest.raises(ServiceError):
        svc.submit(_quick_wf(), BIND, {"seed": 3}, run_id=r1)
    svc.close(timeout=30)


def test_streamed_run_yields_terminal_event():
    svc = _service()
    rid = svc.submit(_quick_wf(), BIND, {"seed": 7}, stream=True)
    events = _drain_stream(svc.stream(rid))
    assert isinstance(events[-1], WorkflowCompleted)
    assert svc.wait(rid, timeout=10).state == COMPLETE
    rid2 = svc.submit(_quick_wf(), BIND, {"seed": 8})
    with pytest.raises(ServiceError):
        svc.stream(rid2)
    svc.close(timeout=30)


# ------------------------------------------------------------- admission

def test_fair_share_interleaves_tenants():
    """With tenant a holding both slots, b's first run is admitted before
    a's backlog when a slot frees (the lowest active / share wins)."""
    svc = _service(ServiceConfig(max_concurrent=2))
    g1, g2, g3 = _gate("fs1"), _gate("fs2"), _gate("fs3")
    a1 = svc.submit(_gated_wf(g1), BIND, {"x": 0}, tenant="a")
    a2 = svc.submit(_gated_wf(g2), BIND, {"x": 0}, tenant="a")
    a3 = svc.submit(_gated_wf(g3), BIND, {"x": 0}, tenant="a")
    b1 = svc.submit(_quick_wf(), BIND, {"seed": 1}, tenant="b")
    _wait_state(svc, a1, RUNNING)
    _wait_state(svc, a2, RUNNING)
    assert svc.status(a3).state == QUEUED
    assert svc.status(b1).state == QUEUED
    GATES[g2].set()                      # a slot frees up
    _wait_state(svc, b1, COMPLETE, timeout=30)
    # b went first: a3 was submitted earlier, but a already held a slot
    assert svc.status(a3).state in (QUEUED, RUNNING)
    GATES[g1].set()
    GATES[g3].set()
    svc.drain(timeout=30)
    assert all(i.state == COMPLETE for i in svc.list_runs())
    svc.close(timeout=30)


def test_priority_orders_within_tenant():
    svc = _service(ServiceConfig(max_concurrent=1))
    g1 = _gate("prio1")
    a1 = svc.submit(_gated_wf(g1), BIND, {"x": 0})
    _wait_state(svc, a1, RUNNING)
    low = svc.submit(_quick_wf(), BIND, {"seed": 1}, priority=0)
    high = svc.submit(_quick_wf(), BIND, {"seed": 2}, priority=5)
    GATES[g1].set()
    svc.drain(timeout=60)
    # one slot admits one run at a time: the later, higher-priority run
    # finished before the lower one started
    assert svc.status(low).started_at >= svc.status(high).finished_at
    svc.close(timeout=30)


def test_tenant_quota_caps_active_runs():
    cfg = ServiceConfig(max_concurrent=4,
                        tenants={"capped": TenantPolicy(max_active=1)})
    svc = _service(cfg)
    g1 = _gate("quota1")
    a1 = svc.submit(_gated_wf(g1), BIND, {"x": 0}, tenant="capped")
    a2 = svc.submit(_quick_wf(), BIND, {"seed": 1}, tenant="capped")
    b1 = svc.submit(_quick_wf(), BIND, {"seed": 2}, tenant="free")
    _wait_state(svc, a1, RUNNING)
    _wait_state(svc, b1, COMPLETE, timeout=30)   # other tenants unaffected
    assert svc.status(a2).state == QUEUED        # the quota holds
    GATES[g1].set()
    svc.drain(timeout=30)
    assert svc.status(a2).state == COMPLETE
    svc.close(timeout=30)


def test_service_config_from_streamflow_file():
    cfg = load_streamflow_file({
        "version": "v1.0",
        "models": {"site": {"type": "local", "config": {
            "services": {"svc": {"replicas": 2}}}}},
        "service": {"max_concurrent": 3,
                    "pool": {"enabled": True, "keepalive_s": 5},
                    "default_max_active": 2,
                    "tenants": {"alice": {"share": 2.0, "max_active": 3}}},
        "workflows": {"demo": {
            "type": "python",
            "config": {"module": "repro_torch.configs.recovery_demo",
                       "args": {"n_blocks": 2, "block_rows": 32,
                                "rounds": 2}},
            "bindings": [{"step": "/",
                          "target": {"model": "site", "service": "svc"}}]}},
    })
    sc = ServiceConfig.from_dict(cfg.service)
    assert sc.max_concurrent == 3 and sc.pool_enabled
    assert sc.keepalive_s == 5 and sc.default_max_active == 2
    assert sc.tenants["alice"].share == 2.0
    assert sc.tenant("alice").max_active == 3
    assert sc.tenant("other").max_active == 2    # the default quota
    svc = WorkflowService(cfg, fault=FaultConfig(speculative=False))
    entry = cfg.workflows["demo"]
    rid = svc.submit(entry.workflow, entry.bindings, {"seed": 7})
    assert svc.wait(rid, timeout=30).state == COMPLETE
    svc.close(timeout=30)
    with pytest.raises(ServiceError):
        ServiceConfig.from_dict({"bogus_key": 1})


# --------------------------------------------------------------- pooling

def test_pool_amortizes_deploys_across_runs():
    svc = _service(ServiceConfig(max_concurrent=4, keepalive_s=60))
    rids = [svc.submit(_quick_wf(), BIND, {"seed": s}) for s in range(8)]
    svc.drain(timeout=120)
    assert all(svc.status(r).state == COMPLETE for r in rids)
    # 8 runs over one pooled site: one physical deploy, not 8
    assert svc.pool.deploy_count == 1
    svc.close(timeout=30)
    assert not svc.pool.manager.deployments_map


def test_unpooled_service_deploys_per_run():
    svc = _service(ServiceConfig(max_concurrent=2, pool_enabled=False))
    assert svc.pool is None and svc.scheduler is None
    rids = [svc.submit(_quick_wf(), BIND, {"seed": s}) for s in range(3)]
    svc.drain(timeout=60)
    deploys = sum(
        sum(1 for e in svc._runs[r].result.deployment_timeline
            if e[1] == "deploy") for r in rids)
    assert deploys == 3                              # the control: one each
    svc.close(timeout=30)


def test_pool_keepalive_evicts_idle_sites():
    svc = _service(ServiceConfig(max_concurrent=2, keepalive_s=0.0))
    rid = svc.submit(_quick_wf(), BIND, {"seed": 7})
    svc.wait(rid, timeout=30)
    deadline = time.time() + 5
    while svc.pool.manager.is_deployed("site") and time.time() < deadline:
        svc.pool.maybe_undeploy_idle()
        time.sleep(0.01)
    assert not svc.pool.manager.is_deployed("site")
    # a later run redeploys through the pool
    rid2 = svc.submit(_quick_wf(), BIND, {"seed": 8})
    assert svc.wait(rid2, timeout=30).state == COMPLETE
    assert svc.pool.deploy_count == 2
    with pytest.warns(DeprecationWarning):
        svc.pool.evict_idle()                        # the old spelling
    svc.close(timeout=30)


# ----------------------------------------------------------- cancellation

def test_cancel_queued_run_never_deploys():
    svc = _service(ServiceConfig(max_concurrent=1))
    g1 = _gate("cq1")
    a1 = svc.submit(_gated_wf(g1), BIND, {"x": 0})
    _wait_state(svc, a1, RUNNING)
    queued = svc.submit(_quick_wf(), BIND, {"seed": 1}, stream=True)
    assert svc.status(queued).state == QUEUED
    deploys_before = svc.pool.deploy_count
    assert svc.cancel(queued) == CANCELED
    info = svc.status(queued)
    assert info.state == CANCELED and info.started_at is None
    # the stream of a run cancelled before admission ends cleanly
    events = _drain_stream(svc.stream(queued))
    assert len(events) == 1 and events[0].pending == []
    GATES[g1].set()
    svc.drain(timeout=30)
    assert svc.pool.deploy_count == deploys_before   # nothing deployed for it
    assert svc.cancel(queued) == CANCELED            # idempotent
    svc.close(timeout=30)


def test_cancel_running_run_reaches_canceled():
    svc = _service(ServiceConfig(max_concurrent=1))
    g1 = _gate("cr1")
    rid = svc.submit(_gated_wf(g1), BIND, {"x": 0})
    _wait_state(svc, rid, RUNNING)
    svc.cancel(rid)
    info = svc.wait(rid, timeout=30)
    assert info.state == CANCELED
    with pytest.raises(RunCancelled):
        svc.result(rid, timeout=30)
    GATES[g1].set()                                  # release the worker
    # the slot freed up: the service keeps admitting
    rid2 = svc.submit(_quick_wf(), BIND, {"seed": 1})
    assert svc.wait(rid2, timeout=30).state == COMPLETE
    svc.close(timeout=30)


SCATTER = dict(n_samples=4, rows_per_sample=4, seq_len=16, train_steps=1,
               batch=2, vocab=64, d_model=16, device="cpu")


def test_cancel_mid_scatter_journal_is_resumable(tmp_path):
    """Cancel the port's §5 scatter run partway: the journal holds a
    terminal ``cancelled`` state, and resume re-runs only the invocations
    that never completed, to a clean run's summary."""
    journal = str(tmp_path / "scatter.jsonl")
    ex = StreamFlowExecutor(
        MODELS, fault=FaultConfig(speculative=False),
        checkpoint=CheckpointConfig(journal_path=journal,
                                    include_payloads=True))

    def hook(tick, completed):
        if len(completed) >= 3:
            ex.cancel()
    ex.tick_hook = hook
    with pytest.raises(RunCancelled):
        ex.run(pipeline.build_scatter_workflow(**SCATTER), BIND,
               {"seed": 7})

    state = ExecutionJournal.replay(journal)
    assert state.cancelled
    pre_completed = set(state.completed_steps)
    assert len(pre_completed) >= 3
    assert set(state.cancelled_pending).isdisjoint(pre_completed)

    ex2 = StreamFlowExecutor(
        MODELS, fault=FaultConfig(speculative=False),
        checkpoint=CheckpointConfig(journal_path=journal,
                                    include_payloads=True))
    res = ex2.resume(journal, pipeline.build_scatter_workflow(**SCATTER),
                     BIND, {"seed": 7})
    rerun = {e.step for e in res.events if e.status == "completed"}
    assert rerun and rerun.isdisjoint(pre_completed)
    assert rerun | pre_completed == set(
        pipeline.build_scatter_workflow(**SCATTER).expand().steps)
    ref = StreamFlowExecutor(
        MODELS, fault=FaultConfig(speculative=False)).run(
        pipeline.build_scatter_workflow(**SCATTER), BIND, {"seed": 7})
    assert repr(res.outputs["summary"]) == repr(ref.outputs["summary"])


def test_cancel_stops_the_count_bodies_launching(monkeypatch):
    """A cancelled run's count bodies read their invocation's cancel event
    before each train step (``pipeline.train_shard``) and raise: no train
    step starts once ``run`` has raised RunCancelled, and the bodies stop
    long before their steps run out.  Each step's start is recorded by
    wrapping the train step the bodies make."""
    starts, lock = [], threading.Lock()
    real = pipeline.make_train_step

    def recording(*args, **kw):
        step = real(*args, **kw)

        def run(*a):
            with lock:
                starts.append(time.monotonic())
            return step(*a)
        return run
    monkeypatch.setattr(pipeline, "make_train_step", recording)
    train_steps, n_samples = 400, 2
    wf = pipeline.build_scatter_workflow(**dict(
        SCATTER, n_samples=n_samples, train_steps=train_steps))
    ex = StreamFlowExecutor(MODELS, fault=FaultConfig(speculative=False))

    def hook(tick, completed):
        with lock:
            if len(starts) >= 2 * n_samples:
                ex.cancel()
    ex.tick_hook = hook
    with pytest.raises(RunCancelled):
        ex.run(wf, BIND, {"seed": 7})
    returned = time.monotonic()
    time.sleep(1.0)
    with lock:
        late = [t - returned for t in starts if t > returned]
        n = len(starts)
    assert late == []
    assert 2 * n_samples <= n < n_samples * train_steps // 2


# --------------------------------------- the deployment manager's races

def test_lease_blocks_idle_eviction():
    mgr = DeploymentManager(MODELS, grace_period_s=0.0)
    mgr.lease("site")
    assert mgr.is_deployed("site")
    assert mgr.maybe_undeploy_idle() == []           # leased: kept
    assert mgr.lease_count("site") == 1
    mgr.release("site")
    assert "site" in mgr.maybe_undeploy_idle()
    assert not mgr.is_deployed("site")


def test_job_started_revives_evicted_site():
    """Idle eviction lands between is_deployed() and job_started():
    job_started redeploys instead of counting jobs on a dead site."""
    mgr = DeploymentManager(MODELS, grace_period_s=0.0)
    mgr.deploy("site")
    mgr.maybe_undeploy_idle()
    assert not mgr.is_deployed("site")
    mgr.job_started("site")
    assert mgr.is_deployed("site")
    assert mgr.deployments_map["site"].active_jobs == 1
    mgr.job_finished("site")


def test_concurrent_deploy_vs_eviction_is_atomic():
    """deploy / job_started / job_finished against a zero-grace eviction
    loop: every started job lands on a live deployment."""
    mgr = DeploymentManager(MODELS, grace_period_s=0.0)
    errors = []
    stop = threading.Event()

    def worker():
        try:
            for _ in range(200):
                mgr.deploy("site")
                mgr.job_started("site")
                if not mgr.is_deployed("site"):
                    errors.append("job started on undeployed site")
                mgr.job_finished("site")
        except Exception as e:                        # noqa: BLE001
            errors.append(repr(e))

    def evictor():
        while not stop.is_set():
            mgr.maybe_undeploy_idle()

    threads = [threading.Thread(target=worker) for _ in range(4)]
    ev = threading.Thread(target=evictor)
    ev.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    ev.join(timeout=10)
    assert not any(t.is_alive() for t in [*threads, ev])
    assert errors == []
    dep = mgr.deployments_map.get("site")
    assert dep is None or dep.active_jobs == 0


def test_redeploy_preserves_leases():
    mgr = DeploymentManager(MODELS, grace_period_s=0.0)
    mgr.lease("site")
    mgr.lease("site")
    mgr.redeploy("site")
    assert mgr.lease_count("site") == 2
    assert mgr.maybe_undeploy_idle() == []
    mgr.release("site")
    mgr.release("site")
    assert "site" in mgr.maybe_undeploy_idle()
