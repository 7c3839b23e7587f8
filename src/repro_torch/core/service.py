"""Multi-tenant workflow service: TES-style submit/status/cancel/list
over the StreamFlow executor (beyond-paper).

The paper's driver runs one workflow to completion; the GA4GH Task
Execution Service API (PAPERS.md) standardizes the long-lived shape a
production orchestrator actually takes: clients *submit* runs, poll
*status*, *cancel* cooperatively, and the service multiplexes everything
over shared execution sites.  This module provides that layer:

  * ``WorkflowService`` — submit/status/cancel/list/stream of ``Run``
    objects.  Admission is per-tenant **fair share** (tenant with the
    lowest active-runs/share ratio admits next) with **priority** and
    FIFO order inside a tenant, under a global ``max_concurrent`` cap and
    optional per-tenant ``max_active`` quotas.

  * **Deployment pooling** — ``DeploymentPool`` wraps ONE shared
    ``DeploymentManager`` in per-run lease façades: a run's ``deploy``
    takes a refcounted lease (``DeploymentManager.lease``), its
    end-of-run ``undeploy_all`` merely releases leases, and sites are
    physically torn down only by idle keep-alive eviction once no run
    leases them.  A hundred runs over a two-model pool pay ~two deploys,
    not two hundred.

  * Cross-run safety — admitted runs share one ``Scheduler`` (true
    occupancy view) with per-run namespaced job names and store keys
    (``StreamFlowExecutor(namespace=...)``), so identical token refs from
    concurrent runs can't collide or falsely R4-elide on a shared site.

  * Cooperative cancellation — ``cancel`` of a RUNNING run propagates to
    in-flight invocations via ``Executor.cancel`` (journaling a terminal
    ``cancelled`` state, resumable); cancel of a QUEUED run retires it
    before admission, deploying nothing.

Run states follow TES: QUEUED -> RUNNING -> COMPLETE / EXECUTOR_ERROR /
CANCELED.  The ``service:`` block of a StreamFlow file configures all of
it (see docs/streamflow-file.md).
"""
from __future__ import annotations

import itertools
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core import analyzer as _analyzer
from repro_torch.core.autoscale import AutoscaleConfig, Autoscaler
from repro_torch.core.deployment import (DeploymentManager, ModelSpec,
                                         replica_base)
from repro_torch.core.events import EventSink, WorkflowCancelled
from repro_torch.core.executor import RunResult, StreamFlowExecutor
from repro_torch.core.persistence import CacheConfig, InvocationCache
from repro_torch.core.scheduler import POLICIES, Scheduler
from repro_torch.core.streamflow_file import StreamFlowConfig
from repro_torch.core.streamflow_file import load as load_streamflow_file

# TES task states (GA4GH Task Execution Service)
QUEUED = "QUEUED"
RUNNING = "RUNNING"
COMPLETE = "COMPLETE"
EXECUTOR_ERROR = "EXECUTOR_ERROR"
CANCELED = "CANCELED"
TERMINAL_STATES = frozenset({COMPLETE, EXECUTOR_ERROR, CANCELED})


class ServiceError(RuntimeError):
    pass


class UnknownRunError(KeyError):
    pass


@dataclass
class TenantPolicy:
    """Per-tenant admission policy: ``share`` weights the fair-share
    ratio (2.0 admits twice as much concurrent work as 1.0 under
    contention); ``max_active`` is a hard quota on concurrently RUNNING
    runs (None = bounded only by the global cap)."""
    share: float = 1.0
    max_active: Optional[int] = None


@dataclass
class ServiceConfig:
    """The ``service:`` block of a StreamFlow file."""
    max_concurrent: int = 8
    pool_enabled: bool = True
    keepalive_s: Optional[float] = 30.0
    default_max_active: Optional[int] = None
    tenants: Dict[str, TenantPolicy] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ServiceConfig":
        d = dict(d or {})
        pool = d.pop("pool", {})
        tenants = {name: TenantPolicy(**t)
                   for name, t in d.pop("tenants", {}).items()}
        unknown = (set(d) - {"max_concurrent", "default_max_active"})
        if unknown:
            raise ServiceError(
                f"unknown service key(s) {sorted(unknown)}")
        return cls(max_concurrent=d.get("max_concurrent", 8),
                   pool_enabled=pool.get("enabled", True),
                   keepalive_s=pool.get("keepalive_s", 30.0),
                   default_max_active=d.get("default_max_active"),
                   tenants=tenants)

    def tenant(self, name: str) -> TenantPolicy:
        pol = self.tenants.get(name)
        if pol is None:
            pol = TenantPolicy(max_active=self.default_max_active)
        return pol


# ----------------------------------------------------------------- pooling
class DeploymentPool:
    """One shared ``DeploymentManager`` + per-run lease façades.

    ``keepalive_s`` is the idle grace period: a site with zero active
    jobs AND zero leases for that long is physically undeployed on the
    next ``evict_idle`` (the per-tick call every hosted executor already
    makes).  ``None`` keeps sites up until ``shutdown``."""

    def __init__(self, models: Dict[str, ModelSpec], *,
                 keepalive_s: Optional[float] = 30.0):
        self.manager = DeploymentManager(models, grace_period_s=keepalive_s)
        self._lock = threading.RLock()

    def lease_manager(self) -> "PooledDeploymentManager":
        return PooledDeploymentManager(self)

    def maybe_undeploy_idle(self, pending_models: Optional[set] = None
                            ) -> List[str]:
        """Idle keep-alive sweep (the DeploymentPlane spelling)."""
        return self.manager.maybe_undeploy_idle(pending_models)

    def evict_idle(self, pending_models: Optional[set] = None) -> List[str]:
        """Deprecated spelling of :meth:`maybe_undeploy_idle`."""
        warnings.warn(
            "DeploymentPool.evict_idle is deprecated; use "
            "maybe_undeploy_idle (the DeploymentPlane spelling)",
            DeprecationWarning, stacklevel=2)
        return self.maybe_undeploy_idle(pending_models)

    @property
    def deploy_count(self) -> int:
        """Physical deploys performed over the pool's lifetime — the
        number pooling exists to keep ~= the model count, not the run
        count."""
        return sum(1 for e in self.manager.timeline if e[1] == "deploy")

    def shutdown(self):
        self.manager.undeploy_all()


class PooledDeploymentManager:
    """Per-run façade duck-typing ``DeploymentManager`` for the executor
    and DataManager: ``deploy`` takes a pool lease on first touch,
    ``undeploy``/``undeploy_all`` release leases instead of tearing
    sites down, and idle eviction is delegated to the pool (which skips
    anything still leased by ANY run)."""

    def __init__(self, pool: DeploymentPool):
        self._pool = pool
        self._inner = pool.manager
        self._leased: set = set()
        self._lock = threading.RLock()
        self.journal = None               # per-run; set by the executor

    # -- lifecycle (lease semantics) ----------------------------------------
    def deploy(self, model_name: str):
        with self._lock:
            if model_name not in self._leased:
                conn = self._inner.lease(model_name)
                self._leased.add(model_name)
                if self.journal is not None:
                    # per-run journal: the run *attached* to a pooled site
                    # (it may well have been deployed by an earlier run)
                    self.journal.deployment(model_name, "attach")
                return conn
        return self._inner.deploy(model_name)

    def undeploy(self, model_name: str):
        with self._lock:
            if model_name not in self._leased:
                return
            self._leased.discard(model_name)
        self._inner.release(model_name)
        if self.journal is not None:
            self.journal.deployment(model_name, "detach")

    def undeploy_all(self):
        """End-of-run (or exception) cleanup: release every lease; the
        pool's keep-alive decides when sites physically go away."""
        with self._lock:
            leased = list(self._leased)
        for model in leased:
            self.undeploy(model)
        self._pool.maybe_undeploy_idle()

    def maybe_undeploy_idle(self, pending_models: Optional[set] = None
                            ) -> List[str]:
        # pool-level eviction: only models NO run leases can go; the
        # executor then forgets them from its per-run scheduler/registry
        return self._pool.maybe_undeploy_idle(pending_models)

    def redeploy(self, model_name: str):
        return self._inner.redeploy(model_name)

    # -- passthroughs (the rest of the DeploymentPlane surface) ---------------
    def lease(self, model_name: str):
        return self._inner.lease(model_name)

    def release(self, model_name: str):
        self._inner.release(model_name)

    def lease_count(self, model_name: str) -> int:
        return self._inner.lease_count(model_name)

    def drain(self, model_name: str, *, preempt: bool = False):
        self._inner.drain(model_name, preempt=preempt)

    def undrain(self, model_name: str):
        self._inner.undrain(model_name)

    def is_draining(self, model_name: str) -> bool:
        return self._inner.is_draining(model_name)

    def replicas_of(self, model_name: str) -> List[str]:
        return self._inner.replicas_of(model_name)

    def spec_of(self, model_name: str) -> Optional[ModelSpec]:
        return self._inner.spec_of(model_name)

    def register(self, spec: ModelSpec):
        self._inner.register(spec)

    def get_connector(self, model_name: str):
        return self._inner.get_connector(model_name)

    def is_deployed(self, model_name: str) -> bool:
        return self._inner.is_deployed(model_name)

    def job_started(self, model_name: str):
        self._inner.job_started(model_name)

    def job_finished(self, model_name: str):
        self._inner.job_finished(model_name)

    @property
    def timeline(self) -> List[tuple]:
        return self._inner.timeline

    def leased_models(self) -> List[str]:
        with self._lock:
            return sorted(self._leased)


# -------------------------------------------------------------------- runs
@dataclass
class Run:
    """One submitted workflow execution (internal bookkeeping)."""
    id: str
    tenant: str
    priority: int
    workflow: Any
    bindings: List[Any]
    inputs: Optional[Dict[str, Any]]
    collect: bool
    checkpoint: Any
    seq: int                               # submission order (FIFO tiebreak)
    state: str = QUEUED
    submitted_at: float = 0.0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None
    result: Optional[RunResult] = None
    error: Optional[BaseException] = None
    executor: Optional[StreamFlowExecutor] = None
    sink: Optional[EventSink] = None       # pre-created when stream=True
    stream: Any = None                     # EventStream once admitted
    done: threading.Event = field(default_factory=threading.Event)


@dataclass
class RunInfo:
    """Immutable status snapshot handed to clients (TES task view)."""
    id: str
    tenant: str
    state: str
    priority: int
    submitted_at: float
    started_at: Optional[float]
    finished_at: Optional[float]
    error: Optional[str]

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES


# ----------------------------------------------------------------- service
class WorkflowService:
    """See module docstring.  Construct from a models dict or a loaded
    ``StreamFlowConfig`` (whose ``service:`` block configures admission
    and pooling); submit ``(workflow, bindings, inputs)`` triples —
    typically a ``WorkflowEntry``'s fields."""

    def __init__(self, models, *, service: Optional[ServiceConfig] = None,
                 policy: Optional[str] = None, cache=None, autoscale=None,
                 **executor_kw):
        if isinstance(models, StreamFlowConfig):
            cfg = models
            models = cfg.models
            if service is None:
                service = ServiceConfig.from_dict(cfg.service)
            if policy is None:
                policy = cfg.policy
            if cache is None:
                cache = cfg.cache or None
            if autoscale is None:
                autoscale = cfg.autoscale or None
        self.config = service or ServiceConfig()
        # cross-run invocation cache (the ``cache:`` block).  scope=service
        # opens ONE shared index handed to every admitted executor, so
        # pooled tenants reuse each other's work; scope=per-run passes the
        # config through and each executor opens the index itself (still
        # persistent — re-runs hit — but runs don't see entries recorded
        # after their own admission).
        self.cache: Optional[InvocationCache] = None
        self._cache_cfg: Optional[CacheConfig] = None
        if isinstance(cache, InvocationCache):
            self.cache = cache
        else:
            self._cache_cfg = (cache if isinstance(cache, CacheConfig)
                               else CacheConfig.from_value(cache))
            if self._cache_cfg is not None \
                    and self._cache_cfg.scope == "service":
                self.cache = InvocationCache.from_config(self._cache_cfg)
        self._models = dict(models)
        self._policy = policy or "data_locality"
        self._executor_kw = executor_kw
        # pooled mode: one shared manager + one shared scheduler (true
        # occupancy view).  Unpooled mode: per-run managers AND per-run
        # schedulers — full isolation, the deploy-per-run control.
        self.pool: Optional[DeploymentPool] = (
            DeploymentPool(self._models, keepalive_s=self.config.keepalive_s)
            if self.config.pool_enabled else None)
        self.scheduler: Optional[Scheduler] = (
            Scheduler(POLICIES[self._policy]())
            if self.pool is not None else None)
        # pool-level autoscaler (the ``autoscale:`` block): ONE control
        # loop over the shared manager + shared scheduler, fed by every
        # admitted run's queue report (namespaced note_queue).  Per-tenant
        # ``max_active`` quotas bound its control input — a tenant at
        # quota can't inflate queue depth and force scale-ups — and
        # ``max_total_replicas`` caps the fleet outright.  Requires the
        # pool (an unpooled service has per-run managers, where the
        # executor-level autoscaler applies instead).
        if isinstance(autoscale, dict):
            autoscale = AutoscaleConfig.from_dict(autoscale)
        self.autoscaler: Optional[Autoscaler] = None
        self._scaler_stop = threading.Event()
        self._scaler_thread: Optional[threading.Thread] = None
        if isinstance(autoscale, AutoscaleConfig) and self.pool is not None:
            self.autoscaler = Autoscaler(
                autoscale, self.pool.manager, self.scheduler,
                topology=executor_kw.get("topology")
                if not isinstance(executor_kw.get("topology"), dict)
                else None)
            self._scaler_thread = threading.Thread(
                target=self._scaler_loop, daemon=True, name="sf-autoscaler")
            self._scaler_thread.start()
        self._lock = threading.RLock()
        self._runs: Dict[str, Run] = {}
        self._seq = itertools.count()
        self._active = 0
        self._closed = False

    def _scaler_loop(self):
        interval = self.autoscaler.config.interval_s
        while not self._scaler_stop.wait(interval):
            try:
                self.autoscaler.tick()
            except Exception:                 # noqa: BLE001 — control loop
                # a failed control iteration must not kill the service;
                # the next tick sees fresh state and tries again
                pass

    # -- submit --------------------------------------------------------------
    def submit(self, workflow, bindings, inputs=None, *,
               tenant: str = "default", priority: int = 0,
               run_id: Optional[str] = None, stream: bool = False,
               buffer: int = 256, checkpoint=None,
               collect: bool = True) -> str:
        """Enqueue a run; returns its id immediately.  ``priority`` ranks
        within the tenant (higher first); ``stream=True`` pre-opens an
        event sink so ``stream(run_id)`` follows the run live (replaying
        nothing: events start at admission)."""
        with self._lock:
            if self._closed:
                raise ServiceError("service is closed")
            seq = next(self._seq)
            rid = run_id if run_id is not None else f"run-{seq}"
            if rid in self._runs:
                raise ServiceError(f"duplicate run id {rid!r}")
            run = Run(id=rid, tenant=tenant, priority=priority,
                      workflow=workflow, bindings=bindings, inputs=inputs,
                      collect=collect, checkpoint=checkpoint, seq=seq,
                      submitted_at=time.time(),
                      sink=EventSink(buffer) if stream else None)
            self._runs[rid] = run
            self._pump_locked()
        return rid

    def submit_document(self, doc, *, workflow: Optional[str] = None,
                        inputs=None, **submit_kw) -> str:
        """Load, statically check and submit a StreamFlow document.

        Checking is forced on regardless of the document's ``check:``
        key: a failing document raises
        :class:`~repro_torch.core.checker.WorkflowCheckError` (typed; carries
        every diagnostic) *before* a Run exists or admission state is
        touched, so a bad document can never occupy a fair-share slot.
        The document's bindings must also resolve against the models
        this service deploys — a document checked against its own
        ``models:`` block but pointed at a service lacking them raises
        :class:`ServiceError`.  ``workflow`` selects among multiple
        workflows in the document (optional when there is exactly one).

        If the document opts in with an ``analyze:`` block, the plan-time
        semantic analyzer (SF3xx) also runs — joined with the scheduler's
        *live* registered capacity when this service shares one — and a
        failing analysis raises
        :class:`~repro_torch.core.analyzer.WorkflowAnalysisError`, again before
        any Run exists.  No block (or ``analyze: off``) skips the pass
        entirely.
        """
        cfg = load_streamflow_file(doc, check=True)
        if _analyzer.AnalyzeConfig.from_value(cfg.analyze) is not None:
            live = None
            if self.scheduler is not None:
                live = {}
                for (model, svc), n in \
                        self.scheduler.export_capacity().items():
                    key = (replica_base(model), svc)
                    live[key] = live.get(key, 0) + n
            _analyzer.gate(cfg, live_capacity=live)
        if workflow is None:
            if len(cfg.workflows) != 1:
                raise ServiceError(
                    f"document declares workflows {sorted(cfg.workflows)};"
                    f" pass workflow=<name> to pick one")
            workflow = next(iter(cfg.workflows))
        entry = cfg.workflows.get(workflow)
        if entry is None:
            raise ServiceError(
                f"document has no workflow {workflow!r} "
                f"(have {sorted(cfg.workflows)})")
        missing = sorted({m for b in entry.bindings
                          for m, _svc in b.targets} - set(self._models))
        if missing:
            raise ServiceError(
                f"workflow {workflow!r} binds model(s) {missing} that this "
                f"service does not deploy (have {sorted(self._models)})")
        return self.submit(entry.workflow, entry.bindings, inputs,
                           **submit_kw)

    # -- admission (fair share + priority + quotas) ---------------------------
    def _pump_locked(self):
        while self._active < self.config.max_concurrent:
            run = self._pick_locked()
            if run is None:
                return
            self._admit_locked(run)

    def _pick_locked(self) -> Optional[Run]:
        active: Dict[str, int] = {}
        for r in self._runs.values():
            if r.state == RUNNING:
                active[r.tenant] = active.get(r.tenant, 0) + 1
        eligible = []
        for r in self._runs.values():
            if r.state != QUEUED:
                continue
            pol = self.config.tenant(r.tenant)
            if pol.max_active is not None \
                    and active.get(r.tenant, 0) >= pol.max_active:
                continue                      # tenant at quota
            eligible.append(r)
        if not eligible:
            return None

        def key(r: Run):
            pol = self.config.tenant(r.tenant)
            ratio = active.get(r.tenant, 0) / max(pol.share, 1e-9)
            return (ratio, -r.priority, r.seq)
        return min(eligible, key=key)

    def _admit_locked(self, run: Run):
        run.state = RUNNING
        run.started_at = time.time()
        self._active += 1
        kw = dict(self._executor_kw)
        kw.setdefault("policy", self._policy)
        if run.checkpoint is not None:
            kw["checkpoint"] = run.checkpoint
        if self.pool is not None:
            kw["deployment"] = self.pool.lease_manager()
            kw["scheduler"] = self.scheduler
            kw["namespace"] = f"{run.id}/"
        if self.autoscaler is not None:
            # the service owns the ONE control loop; runs just feed it
            # queue pressure and expose their data planes for stage-off
            kw["autoscale"] = None
            kw["report_queue"] = True
        if self.cache is not None:
            kw.setdefault("cache", self.cache)
        elif self._cache_cfg is not None:
            kw.setdefault("cache", self._cache_cfg)
        run.executor = StreamFlowExecutor(self._models, **kw)
        if self.autoscaler is not None:
            self.autoscaler.attach_data(run.executor.data)
        if run.sink is not None:
            run.stream = run.executor.run_stream(
                run.workflow, run.bindings, run.inputs, run.collect,
                sink=run.sink)
            run.stream.add_done_callback(
                lambda es, run=run: self._finish(run, es._result, es._error))
        else:
            threading.Thread(target=self._drive, args=(run,),
                             daemon=True, name=f"sf-run-{run.id}").start()

    def _drive(self, run: Run):
        try:
            result = run.executor.run(run.workflow, run.bindings,
                                      run.inputs, run.collect)
            self._finish(run, result, None)
        except BaseException as e:          # noqa: BLE001 — recorded on Run
            self._finish(run, None, e)

    def _finish(self, run: Run, result, error):
        from repro_torch.core.events import RunCancelled
        with self._lock:
            run.finished_at = time.time()
            run.result = result
            run.error = error
            if error is None:
                run.state = COMPLETE
            elif isinstance(error, RunCancelled):
                run.state = CANCELED
            else:
                run.state = EXECUTOR_ERROR
            self._active -= 1
            run.done.set()
            self._pump_locked()
        if self.autoscaler is not None and run.executor is not None:
            self.autoscaler.detach_data(run.executor.data)
        if self.pool is not None:
            self.pool.maybe_undeploy_idle()

    # -- TES API --------------------------------------------------------------
    def _run(self, run_id: str) -> Run:
        run = self._runs.get(run_id)
        if run is None:
            raise UnknownRunError(run_id)
        return run

    def status(self, run_id: str) -> RunInfo:
        with self._lock:
            r = self._run(run_id)
            return RunInfo(r.id, r.tenant, r.state, r.priority,
                           r.submitted_at, r.started_at, r.finished_at,
                           None if r.error is None else str(r.error))

    def list_runs(self, *, tenant: Optional[str] = None,
                  state: Optional[str] = None) -> List[RunInfo]:
        with self._lock:
            runs = sorted(self._runs.values(), key=lambda r: r.seq)
        return [self.status(r.id) for r in runs
                if (tenant is None or r.tenant == tenant)
                and (state is None or r.state == state)]

    def cancel(self, run_id: str) -> str:
        """Cancel a run.  QUEUED: retired immediately — it was never
        admitted, so nothing was ever deployed for it.  RUNNING:
        cooperative — the executor journals ``cancelled`` and the run
        reaches CANCELED when the flag lands.  Terminal states are
        returned unchanged (idempotent)."""
        with self._lock:
            run = self._run(run_id)
            if run.state == QUEUED:
                run.state = CANCELED
                run.finished_at = time.time()
                run.done.set()
                if run.sink is not None:
                    run.sink.emit(WorkflowCancelled(pending=[]))
                    run.sink.close()
                return CANCELED
            if run.state == RUNNING:
                run.executor.cancel()
                return RUNNING
            return run.state

    def stream(self, run_id: str):
        """Iterate a run's live events (requires ``submit(stream=True)``).
        Usable immediately after submit — events begin at admission."""
        with self._lock:
            run = self._run(run_id)
            if run.sink is None:
                raise ServiceError(
                    f"run {run_id!r} was not submitted with stream=True")
        return run.sink.events()

    def wait(self, run_id: str, timeout: Optional[float] = None) -> RunInfo:
        """Block until the run is terminal; returns the final snapshot."""
        run = self._run(run_id)
        if not run.done.wait(timeout):
            raise TimeoutError(f"run {run_id!r} still {run.state}")
        return self.status(run_id)

    def result(self, run_id: str,
               timeout: Optional[float] = None) -> RunResult:
        """Block for COMPLETE and return the RunResult; re-raises the
        run's error for EXECUTOR_ERROR/CANCELED."""
        self.wait(run_id, timeout)
        run = self._run(run_id)
        if run.error is not None:
            raise run.error
        return run.result

    def drain(self, timeout: Optional[float] = None):
        """Wait until every submitted run is terminal."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            with self._lock:
                pending = [r for r in self._runs.values()
                           if r.state not in TERMINAL_STATES]
            if not pending:
                return
            left = None if deadline is None else deadline - time.time()
            if left is not None and left <= 0:
                raise TimeoutError(
                    f"{len(pending)} run(s) still not terminal")
            pending[0].done.wait(min(0.2, left) if left is not None else 0.2)

    def close(self, *, cancel_pending: bool = True,
              timeout: Optional[float] = None):
        """Stop admitting, optionally cancel whatever isn't terminal,
        drain, and tear the pool down."""
        with self._lock:
            self._closed = True
            pending = [r.id for r in self._runs.values()
                       if r.state not in TERMINAL_STATES]
        if cancel_pending:
            for rid in pending:
                self.cancel(rid)
        self.drain(timeout)
        if self.autoscaler is not None:
            self._scaler_stop.set()
            if self._scaler_thread is not None:
                self._scaler_thread.join(timeout=5.0)
            self.autoscaler.shutdown()
        if self.pool is not None:
            self.pool.shutdown()
        if self.cache is not None:
            self.cache.close()
