"""DeploymentManager (paper §4.5): lazy, atomic model lifecycle.

R1: a model (multi-container environment / mesh site) deploys as a unit,
before its first task, and undeploys after its last.  R2: many tasks may
share one deployment — the lock guarantees exactly-once deploy under
concurrent requests; later callers get a fresh Connector façade onto the
same site.  ``external: true`` models are user-managed (attach only).

Beyond-paper (flagged): grace-period undeploy — the paper names this as the
better strategy for dynamically-growing workflows but ships undeploy-at-end;
we implement both (``grace_period_s``), defaulting to the paper's behaviour.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, runtime_checkable

from repro_torch.core.connector import Connector
from repro_torch.core.connectors import get_external_site, make_connector

#: separator between a model's base name and an autoscaled replica ordinal
#: ("compute~2" is the second extra replica site of model "compute")
REPLICA_SEP = "~"


def replica_base(model_name: str) -> str:
    """Base model behind a (possibly autoscaled-replica) site name."""
    return model_name.split(REPLICA_SEP, 1)[0]


@dataclass
class ModelSpec:
    name: str
    type: str
    config: dict = field(default_factory=dict)
    external: bool = False


@runtime_checkable
class DeploymentPlane(Protocol):
    """THE deployment lifecycle API: one protocol for every site manager.

    Both :class:`DeploymentManager` (the direct, per-run manager) and the
    service's pooled per-run façade implement it, so anything driving
    site lifecycle — the executor, the DataManager, the Autoscaler —
    targets a single surface:

      deploy / undeploy            bring a model up / tear it down
      lease / release / lease_count  refcount pinning a site against idle
                                   eviction (a real refcount on the
                                   non-pooled manager too — deploy-if-
                                   needed plus a count, otherwise a no-op)
      maybe_undeploy_idle          grace-period eviction sweep
      drain / undrain / is_draining  stop scheduling onto a site ahead of
                                   a planned scale-down or preemption
      replicas_of / spec_of        autoscaled replica sites of a model
    """

    def register(self, spec: ModelSpec) -> None: ...
    def deploy(self, model_name: str) -> Connector: ...
    def undeploy(self, model_name: str) -> None: ...
    def undeploy_all(self) -> None: ...
    def lease(self, model_name: str) -> Connector: ...
    def release(self, model_name: str) -> None: ...
    def lease_count(self, model_name: str) -> int: ...
    def maybe_undeploy_idle(
            self, pending_models: Optional[set] = None) -> List[str]: ...
    def drain(self, model_name: str, *, preempt: bool = False) -> None: ...
    def undrain(self, model_name: str) -> None: ...
    def is_draining(self, model_name: str) -> bool: ...
    def replicas_of(self, model_name: str) -> List[str]: ...
    def spec_of(self, model_name: str) -> Optional[ModelSpec]: ...
    def get_connector(self, model_name: str) -> Optional[Connector]: ...
    def is_deployed(self, model_name: str) -> bool: ...
    def job_started(self, model_name: str) -> None: ...
    def job_finished(self, model_name: str) -> None: ...
    def redeploy(self, model_name: str) -> Connector: ...


@dataclass
class _Deployment:
    connector: Connector
    deployed_at: float
    active_jobs: int = 0
    last_used: float = 0.0
    # refcount held by long-lived users (one per concurrent run through the
    # service's deployment pool): a leased site is never idle-undeployed,
    # no matter how long since its last job
    leases: int = 0
    events: List[tuple] = field(default_factory=list)  # (event, t)


class DeploymentManager:
    def __init__(self, model_specs: Dict[str, ModelSpec], *,
                 grace_period_s: Optional[float] = None, journal=None):
        self._specs = dict(model_specs)                    # lock: _lock
        self._lock = threading.RLock()
        self.deployments_map: Dict[str, _Deployment] = {}  # lock: _lock
        self.grace_period_s = grace_period_s
        self.journal = journal                    # ExecutionJournal | None
        self.timeline: List[tuple] = []           # (model, event, t)
        # drain flags OUTLIVE the deployment entry: a preempted replica
        # must stay unschedulable after its undeploy, or the executor's
        # fault path would resurrect the very site the autoscaler revoked
        self._draining: set = set()               # lock: _lock

    def _journal(self, model: str, event: str):
        if self.journal is not None:
            self.journal.deployment(model, event)

    def register(self, spec: ModelSpec):
        with self._lock:
            self._specs[spec.name] = spec

    def spec_of(self, model_name: str) -> Optional[ModelSpec]:
        with self._lock:
            return self._specs.get(model_name)

    # -- paper API ------------------------------------------------------------
    def deploy(self, model_name: str) -> Connector:
        """Atomically deploy-if-needed; returns a Connector façade (R1/R2)."""
        with self._lock:
            dep = self.deployments_map.get(model_name)
            if dep is None:
                spec = self._specs[model_name]
                if spec.external:
                    # attach-only: prefer a still-live user-managed site
                    # (this is what resume() re-attaches to after a crash)
                    conn = get_external_site(spec.name)
                    if conn is None:
                        conn = make_connector(spec.name, spec.type,
                                              spec.config)
                        conn.deployed = True
                    self._journal(model_name, "attach")
                else:
                    conn = make_connector(spec.name, spec.type, spec.config)
                    t0 = time.time()
                    conn.deploy()
                    self.timeline.append((model_name, "deploy", t0,
                                          time.time()))
                    self._journal(model_name, "deploy")
                dep = _Deployment(conn, time.time())
                self.deployments_map[model_name] = dep
            dep.last_used = time.time()
            return dep.connector.clone()

    def get_connector(self, model_name: str) -> Optional[Connector]:
        with self._lock:
            dep = self.deployments_map.get(model_name)
            return dep.connector.clone() if dep else None

    def is_deployed(self, model_name: str) -> bool:
        with self._lock:
            return model_name in self.deployments_map

    # -- lease layer (deployment pooling across concurrent runs) ----------------
    def lease(self, model_name: str) -> Connector:
        """Deploy-if-needed AND take a refcount, atomically: between a
        caller's ``deploy``/``is_deployed`` and its first ``job_started``
        there is otherwise a window where ``maybe_undeploy_idle`` can tear
        the site down under it.  A leased model survives idle eviction
        until every lease is released."""
        with self._lock:
            conn = self.deploy(model_name)
            self.deployments_map[model_name].leases += 1
            return conn

    def release(self, model_name: str):
        with self._lock:
            dep = self.deployments_map.get(model_name)
            if dep is not None:
                dep.leases = max(0, dep.leases - 1)
                dep.last_used = time.time()

    def lease_count(self, model_name: str) -> int:
        with self._lock:
            dep = self.deployments_map.get(model_name)
            return dep.leases if dep is not None else 0

    # -- drain layer (planned scale-down / preemption) -------------------------
    def drain(self, model_name: str, *, preempt: bool = False):
        """Raise a site's drain flag: schedulers and the executor stop
        placing work onto it; the flag survives the eventual undeploy so
        the fault path never redeploys a revoked site.  Journaled as a
        *planned* ``drain`` (or ``preempt``) deployment event — a
        replayed journal distinguishes it from a crash."""
        with self._lock:
            if model_name in self._draining:
                return
            self._draining.add(model_name)
        self._journal(model_name, "preempt" if preempt else "drain")

    def undrain(self, model_name: str):
        with self._lock:
            self._draining.discard(model_name)

    def is_draining(self, model_name: str) -> bool:
        with self._lock:
            return model_name in self._draining

    def draining_models(self) -> List[str]:
        with self._lock:
            return sorted(self._draining)

    def replicas_of(self, model_name: str) -> List[str]:
        """Deployed sites of a model: the base name plus every live
        autoscaled replica ("m", "m~1", ...).  The base is always listed
        (deployed or not — the executor deploys it lazily); replicas only
        while they are actually up."""
        base = replica_base(model_name)
        with self._lock:
            reps = sorted(n for n in self.deployments_map
                          if n != base and replica_base(n) == base)
        return [base, *reps]

    def undeploy(self, model_name: str):
        with self._lock:
            dep = self.deployments_map.pop(model_name, None)
        if dep is not None:
            self._teardown(model_name, dep)

    def _teardown(self, model_name: str, dep: _Deployment):
        """Physical teardown of a deployment already popped from the map."""
        t0 = time.time()
        with self._lock:
            spec = self._specs.get(model_name)
        if spec is None or not spec.external:
            dep.connector.undeploy()
            self._journal(model_name, "undeploy")
        else:
            self._journal(model_name, "detach")
        self.timeline.append((model_name, "undeploy", t0, time.time()))

    def undeploy_all(self):
        """End-of-workflow / on-exception cleanup (paper's conservative
        strategy; also prevents resource waste on failure)."""
        with self._lock:
            names = list(self.deployments_map)
        for n in names:
            self.undeploy(n)

    # -- job accounting (drives the grace-period policy) -----------------------
    def job_started(self, model_name: str):
        with self._lock:
            dep = self.deployments_map.get(model_name)
            if dep is None and model_name in self._specs:
                # the scheduled-but-evicted race (idle undeploy won between
                # the caller's deploy() and this job_started): revive the
                # site under the same lock rather than run on a dead one
                self.deploy(model_name)
                dep = self.deployments_map.get(model_name)
            if dep:
                dep.active_jobs += 1
                dep.last_used = time.time()

    def job_finished(self, model_name: str):
        with self._lock:
            dep = self.deployments_map.get(model_name)
            if dep:
                dep.active_jobs = max(0, dep.active_jobs - 1)
                dep.last_used = time.time()

    def maybe_undeploy_idle(self, pending_models: Optional[set] = None):
        """Beyond-paper: release sites idle longer than the grace period,
        unless queued work still needs them (or a lease pins them).

        Selection AND removal happen under one lock hold — the old
        check-then-undeploy split left a window where a concurrent run
        could ``deploy``/``is_deployed`` a model and have it torn down
        before its ``job_started`` landed.  Physical teardown still
        happens outside the lock (it can be slow), on deployments already
        invisible to every other caller."""
        if self.grace_period_s is None:
            return []
        now = time.time()
        popped = []
        with self._lock:
            idle = [n for n, d in self.deployments_map.items()
                    if d.active_jobs == 0 and d.leases == 0
                    and now - d.last_used >= self.grace_period_s
                    and (pending_models is None or n not in pending_models)]
            for n in idle:
                popped.append((n, self.deployments_map.pop(n)))
        for n, dep in popped:
            self._teardown(n, dep)
        return [n for n, _ in popped]

    # -- health ------------------------------------------------------------------
    def redeploy(self, model_name: str) -> Connector:
        """Fault path: drop and re-create a failed site (R1 makes this clean —
        the unit redeploys atomically; the registry replays lost tokens).
        Atomic under the lock, and lease counts survive: concurrent runs
        holding the dead site keep their idle-eviction protection on the
        fresh one."""
        with self._lock:
            prev = self.deployments_map.get(model_name)
            leases = prev.leases if prev is not None else 0
            self.undeploy(model_name)
            conn = self.deploy(model_name)
            self.deployments_map[model_name].leases = leases
            return conn
