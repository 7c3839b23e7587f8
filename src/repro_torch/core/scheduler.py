"""Task scheduling (paper §4.4): fireable-task queue + pluggable Policy.

The Policy interface is kept argument-for-argument (Fig. 3):
``get_resource(job_description, available_resources, remote_paths, jobs,
resources)``.  Default = the paper's data-locality policy: walk the job's
data dependencies (largest first) and take the first *free* resource already
holding one; else any free resource; else None -> the task waits.

Beyond-paper (flagged): queue-aware scheduling.  The paper notes such
strategies "cannot currently be implemented" in its one-task-at-a-time FCFS
loop; our pipelined executor hands policies the *whole* ready queue each
tick via ``Scheduler.schedule_batch``.  Policies may implement two optional
hooks on top of ``get_resource``:

  order_queue(queue, remote_paths, resources)   -> reordered queue
  select_batch(queue, available, remote_paths, jobs, resources)
                                                -> [(job, resource), ...]

Three queue-aware policies ship behind the same interface: ``backfill``
(FCFS head never starves later jobs of their locality targets),
``locality_batch`` (batch-wide greedy matching of jobs to data holders,
largest transfers first) and ``widest_first`` (jobs unlocking the most
successors run first, maximising downstream parallelism).

Beyond-paper (flagged): scatter-aware placement.  Jobs carry their
scatter identity (``JobDescription.group``/``tag`` — the declared step
behind an invocation); ``scatter_spread`` balances each group's
invocations across the models its binding targets, so one wide scatter
fans out over every site instead of flooding the first.
"""
from __future__ import annotations

import abc
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.workflow import Requirements


class JobStatus(Enum):
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"


@dataclass
class JobDescription:
    name: str                                     # invocation path (+attempt)
    requirements: Requirements
    # token -> size in bytes (data dependencies, for locality reasoning)
    data_deps: Dict[str, int] = field(default_factory=dict)
    service: str = "default"
    # successor steps this job's outputs unlock (widest-first reasoning)
    fanout: int = 0
    # scatter identity: the declared step behind this invocation and its
    # tag — lets policies reason about a whole scatter group at once
    group: str = ""
    tag: Tuple[int, ...] = ()


@dataclass
class JobAllocation:
    job: JobDescription
    resource: str
    status: JobStatus = JobStatus.RUNNING


@dataclass
class ResourceAllocation:
    model: str
    service: str
    jobs: List[str] = field(default_factory=list)  # running job names
    cores: int = 1
    memory_gb: float = 4.0


RemotePaths = Dict[str, List[Tuple[str, str]]]     # token -> [(resource, path)]


@dataclass(frozen=True)
class SchedulerSnapshot:
    """Typed, immutable view of the scheduler's live state.

    This is both the journal record (``to_dict()`` is exactly what
    ``ExecutionJournal.scheduler_state`` writes — the historical raw-dict
    shape is preserved key for key) and the Autoscaler's control input
    (per-model/per-service queue depth, per-model running counts, drain
    flags), so the scaling loop reasons over the same object a replayed
    journal shows.
    """
    #: job name -> {"resource": ..., "status": ...}
    jobs: Dict[str, Dict[str, str]]
    #: resource name -> {"model": ..., "service": ..., "jobs": [...]}
    resources: Dict[str, Dict[str, Any]]
    #: model -> queued (placeable-but-unplaced) jobs naming it as a target
    queue_depth: Dict[str, int] = field(default_factory=dict)
    #: service -> queued jobs bound to it
    service_queue_depth: Dict[str, int] = field(default_factory=dict)
    #: model -> running job count
    running: Dict[str, int] = field(default_factory=dict)
    #: models currently draining (no new placements land on them)
    draining: Tuple[str, ...] = ()

    def to_dict(self) -> dict:
        """JSON-safe form, journal-shape-compatible: the historical
        ``{"jobs": ..., "resources": ...}`` keys are always present and
        unchanged; queue/drain telemetry is added only when non-empty, so
        runs without an autoscaler journal byte-identical records."""
        out: dict = {"jobs": {n: dict(j) for n, j in self.jobs.items()},
                     "resources": {n: dict(r)
                                   for n, r in self.resources.items()}}
        if self.queue_depth or self.service_queue_depth:
            out["queue"] = {"models": dict(self.queue_depth),
                            "services": dict(self.service_queue_depth)}
        if self.draining:
            out["draining"] = list(self.draining)
        return out

    def __getitem__(self, key: str):
        # historical consumers indexed the raw export_state() dict
        return self.to_dict()[key]


def _loc_resource(loc) -> str:
    """Accept (resource, path) tuples or DataManager _Location records."""
    if isinstance(loc, (tuple, list)):
        return loc[0]
    return getattr(loc, "resource")


def _loc_model(loc, resources: Dict[str, "ResourceAllocation"]
               ) -> Optional[str]:
    """Model holding a replica: the _Location's own field when present,
    else resolved through the resource registry (tuple-shaped entries)."""
    model = getattr(loc, "model", None)
    if model is not None:
        return model
    res = resources.get(_loc_resource(loc))
    return res.model if res is not None else None


class Policy(abc.ABC):
    @abc.abstractmethod
    def get_resource(self, job_description: JobDescription,
                     available_resources: Sequence[str],
                     remote_paths: RemotePaths,
                     jobs: Dict[str, JobAllocation],
                     resources: Dict[str, ResourceAllocation]
                     ) -> Optional[str]:
        ...


def _fits(job: JobDescription, res: ResourceAllocation) -> bool:
    return (res.cores >= job.requirements.cores
            and res.memory_gb >= job.requirements.memory_gb)


def _free(name: str, resources: Dict[str, ResourceAllocation]) -> bool:
    res = resources.get(name)
    return res is not None and not res.jobs


class DataLocalityPolicy(Policy):
    """The paper's default: largest dependency's holder first, if free.

    Beyond-paper (flagged): with a ``topology`` attached (the executor
    sets it from the StreamFlow file's ``topology:`` block), holder-match
    becomes *cost-weighted* — every free resource is scored by the
    planner's estimated cost of moving the job's dependencies to its
    model, and the cheapest wins.  A resource holding the data still
    scores 0, so the paper's behaviour is the zero-cost special case.
    """

    topology = None                      # TopologyGraph | None

    def get_resource(self, job, available, remote_paths, jobs, resources):
        if self.topology is not None and job.data_deps:
            target = _cost_target(job, available, remote_paths, resources,
                                  self.topology)
            if target is not None:
                return target
        target = _locality_target(job, available, remote_paths, resources)
        if target is not None:
            return target
        for resource in available:
            if _free(resource, resources) and _fits(job, resources[resource]):
                return resource
        return None


class RoundRobinPolicy(Policy):
    def __init__(self):
        self._next = 0
        self._lock = threading.Lock()

    def get_resource(self, job, available, remote_paths, jobs, resources):
        with self._lock:
            order = list(available)
            for k in range(len(order)):
                cand = order[(self._next + k) % len(order)]
                if _free(cand, resources) and _fits(job, resources[cand]):
                    self._next = (self._next + k + 1) % len(order)
                    return cand
        return None


class LoadBalancePolicy(Policy):
    """Fewest running jobs wins (allows oversubscription)."""

    def get_resource(self, job, available, remote_paths, jobs, resources):
        best, best_load = None, None
        for cand in available:
            res = resources.get(cand)
            if res is None or not _fits(job, res):
                continue
            load = len(res.jobs)
            if best_load is None or load < best_load:
                best, best_load = cand, load
        return best


def _locality_target(job: JobDescription, candidates,
                     remote_paths: RemotePaths,
                     resources: Dict[str, ResourceAllocation]
                     ) -> Optional[str]:
    """The free resource already holding this job's largest dependency."""
    for token, _size in sorted(job.data_deps.items(), key=lambda kv: -kv[1]):
        for loc in remote_paths.get(token, []):
            resource = _loc_resource(loc)
            if (resource in candidates and _free(resource, resources)
                    and _fits(job, resources[resource])):
                return resource
    return None


def _cost_target(job: JobDescription, candidates,
                 remote_paths: RemotePaths,
                 resources: Dict[str, ResourceAllocation],
                 topology) -> Optional[str]:
    """Cost-weighted locality (beyond-paper): score each free, fitting
    candidate by the link-graph cost of assembling the job's dependencies
    on its model — cheapest replica per token, management push when no
    replica exists — and take the argmin.  Cost ties break toward the
    candidate already holding the most dependency bytes (then queue
    order), so with free links this degenerates to the paper's
    holder-match rather than first-free."""
    from repro_torch.core.topology import MANAGEMENT
    best, best_key = None, None
    for cand in candidates:
        res = resources.get(cand)
        if res is None or res.jobs or not _fits(job, res):
            continue
        total, held = 0.0, 0
        for token, size in job.data_deps.items():
            costs = []
            for loc in remote_paths.get(token, []):
                if _loc_resource(loc) == cand:
                    held += max(size, 1)
                src_model = _loc_model(loc, resources)
                if src_model is None:
                    continue
                costs.append(topology.cost(src_model, res.model,
                                           max(size, 1)))
            # no replica anywhere: the bytes come down from the
            # management node wherever the job lands
            total += min(costs) if costs else topology.cost(
                MANAGEMENT, res.model, max(size, 1))
        key = (total, -held)
        if best_key is None or (key[0] < best_key[0] - 1e-12
                                or (abs(key[0] - best_key[0]) <= 1e-12
                                    and key[1] < best_key[1])):
            best, best_key = cand, key
    return best


class BackfillPolicy(Policy):
    """Beyond-paper queue-aware policy: FCFS with backfill.  Each queued job
    first claims its free locality target; a job whose holder is busy (or
    who has none) *backfills* onto free resources nobody later in the queue
    has claimed as a locality target — so the queue head can't starve a
    later job of the one resource that would make its transfer free.
    Exploits the pipelined executor's whole-queue scheduling mode."""

    def __init__(self):
        self.inner = DataLocalityPolicy()

    def get_resource(self, job, available, remote_paths, jobs, resources):
        return self.inner.get_resource(job, available, remote_paths, jobs,
                                       resources)

    def order_queue(self, queue: List[JobDescription],
                    remote_paths: RemotePaths,
                    resources: Dict[str, ResourceAllocation]
                    ) -> List[JobDescription]:
        """Shortest-data-first among ready jobs whose locality target is
        free; jobs blocked on busy holders sink (they'd wait anyway)."""
        def key(j: JobDescription):
            for token, _ in sorted(j.data_deps.items(), key=lambda kv: -kv[1]):
                for loc in remote_paths.get(token, []):
                    if _free(_loc_resource(loc), resources):
                        return (0, -sum(j.data_deps.values()))
            return (1, sum(j.data_deps.values()))
        return sorted(queue, key=key)

    def select_batch(self, queue: Sequence[JobDescription],
                     available: Dict[str, Sequence[str]],
                     remote_paths: RemotePaths,
                     jobs: Dict[str, "JobAllocation"],
                     resources: Dict[str, ResourceAllocation]
                     ) -> List[Tuple[JobDescription, str]]:
        claimed: set = set()
        # pass 1: every job pins its free locality target
        targets: Dict[str, Optional[str]] = {}
        for job in queue:
            t = _locality_target(job, available.get(job.name, ()),
                                 remote_paths, resources)
            if t is not None and t not in claimed:
                targets[job.name] = t
                claimed.add(t)
            else:
                targets[job.name] = None
        # pass 2: FCFS; locality winners take their pin, the rest backfill
        # onto free resources nobody pinned
        out: List[Tuple[JobDescription, str]] = []
        for job in queue:
            pin = targets[job.name]
            if pin is not None:
                out.append((job, pin))
                continue
            for resource in available.get(job.name, ()):
                if (resource not in claimed and _free(resource, resources)
                        and _fits(job, resources[resource])):
                    out.append((job, resource))
                    claimed.add(resource)
                    break
        return out


class LocalityBatchPolicy(Policy):
    """Beyond-paper queue-aware policy: batch-wide locality matching.
    Jobs with the largest data dependencies pick their holders first
    (a greedy weighted matching), so one tick's placement minimises the
    bytes the whole batch will move, not just the queue head's."""

    def __init__(self):
        self.inner = DataLocalityPolicy()

    def get_resource(self, job, available, remote_paths, jobs, resources):
        return self.inner.get_resource(job, available, remote_paths, jobs,
                                       resources)

    def select_batch(self, queue, available, remote_paths, jobs, resources):
        claimed: set = set()
        out: List[Tuple[JobDescription, str]] = []
        ordered = sorted(queue, key=lambda j: -sum(j.data_deps.values()))
        leftovers = []
        for job in ordered:
            cands = [r for r in available.get(job.name, ())
                     if r not in claimed]
            t = _locality_target(job, cands, remote_paths, resources)
            if t is not None:
                out.append((job, t))
                claimed.add(t)
            else:
                leftovers.append(job)
        for job in leftovers:                     # FCFS over what's left
            for resource in available.get(job.name, ()):
                if (resource not in claimed and _free(resource, resources)
                        and _fits(job, resources[resource])):
                    out.append((job, resource))
                    claimed.add(resource)
                    break
        return out


class WidestFirstPolicy(Policy):
    """Beyond-paper queue-aware policy: jobs whose outputs unlock the most
    successors (``JobDescription.fanout``) schedule first, keeping the ready
    queue wide — the classic critical-path heuristic for fork-join DAGs.
    Placement itself stays locality-aware."""

    def __init__(self):
        self.inner = DataLocalityPolicy()

    def get_resource(self, job, available, remote_paths, jobs, resources):
        return self.inner.get_resource(job, available, remote_paths, jobs,
                                       resources)

    def order_queue(self, queue: List[JobDescription],
                    remote_paths: RemotePaths,
                    resources: Dict[str, ResourceAllocation]
                    ) -> List[JobDescription]:
        return sorted(queue, key=lambda j: -j.fanout)


class ScatterSpreadPolicy(Policy):
    """Beyond-paper scatter-aware policy: per-invocation placement that
    balances each scatter *group* (``JobDescription.group`` — the declared
    step behind the invocations) across models.  Candidate models are
    tried least-occupied-by-this-group first, so a 32-wide scatter lands
    roughly evenly on every site its binding targets instead of flooding
    the first one; placement *within* the chosen model stays
    data-locality (an inner :class:`DataLocalityPolicy`, cost-weighted
    when a topology is attached)."""

    def __init__(self):
        self.inner = DataLocalityPolicy()

    def get_resource(self, job, available, remote_paths, jobs, resources):
        group = job.group or job.name
        running: Dict[str, int] = {}            # model -> group members
        for alloc in jobs.values():
            if alloc.status is not JobStatus.RUNNING:
                continue
            if (alloc.job.group or alloc.job.name) != group:
                continue
            res = resources.get(alloc.resource)
            if res is not None:
                running[res.model] = running.get(res.model, 0) + 1
        by_model: Dict[str, List[str]] = {}
        for cand in available:
            res = resources.get(cand)
            if res is None or res.jobs or not _fits(job, res):
                continue
            by_model.setdefault(res.model, []).append(cand)
        for model in sorted(by_model,
                            key=lambda m: (running.get(m, 0), m)):
            got = self.inner.get_resource(job, by_model[model],
                                          remote_paths, jobs, resources)
            if got is not None:
                return got
        return None


POLICIES = {
    "data_locality": DataLocalityPolicy,
    "round_robin": RoundRobinPolicy,
    "load_balance": LoadBalancePolicy,
    "backfill": BackfillPolicy,
    "locality_batch": LocalityBatchPolicy,
    "widest_first": WidestFirstPolicy,
    "scatter_spread": ScatterSpreadPolicy,
}


class Scheduler:
    """Tracks allocations.  Answers one job at a time (``schedule``, the
    paper's FCFS contract) or a whole ready queue per tick
    (``schedule_batch``, the pipelined executor's contract) — queue-aware
    policies see every fireable job before any placement is committed."""

    def __init__(self, policy: Optional[Policy] = None, *, topology=None):
        self.policy = policy or DataLocalityPolicy()
        self.jobs: Dict[str, JobAllocation] = {}
        self.resources: Dict[str, ResourceAllocation] = {}
        self._lock = threading.RLock()
        # job name -> (service, candidate model names): the still-unplaced
        # queue, reported by the executor each tick (autoscaling runs only)
        self._queued: Dict[str, Tuple[str, Tuple[str, ...]]] = {}  # lock: _lock
        # models with the drain flag up: placement skips their resources
        self._draining: set = set()                                # lock: _lock
        self.topology = None
        if topology is not None:
            self.set_topology(topology)

    def set_topology(self, topology):
        """Attach the link-cost graph: locality policies become
        cost-weighted (the queue-aware wrappers delegate placement to an
        inner DataLocalityPolicy, which gets the graph too)."""
        self.topology = topology
        self.policy.topology = topology
        inner = getattr(self.policy, "inner", None)
        if inner is not None:
            inner.topology = topology

    def register_resource(self, name: str, model: str, service: str,
                          cores: int, memory_gb: float):
        with self._lock:
            if name not in self.resources:
                self.resources[name] = ResourceAllocation(
                    model, service, [], cores, memory_gb)

    def forget_model(self, model: str):
        with self._lock:
            for name in [n for n, r in self.resources.items()
                         if r.model == model]:
                del self.resources[name]

    # -- autoscaler control surface (queue depth + drain flags) ---------------
    def note_queue(self, entries: Sequence[Tuple[str, str,
                                                 Sequence[str]]],
                   ns: str = ""):
        """Report the still-unplaced ready queue: ``(job name, service,
        candidate models)`` triples.  Replaces the previous report — the
        executor calls this once per scheduling tick, so the snapshot's
        queue depth is the live backlog, not an accumulation.  Under a
        shared scheduler each run reports with its namespace prefix
        (``ns``), replacing only its own entries."""
        fresh = {name: (service, tuple(models))
                 for name, service, models in entries}
        with self._lock:
            if ns:
                for k in [k for k in self._queued if k.startswith(ns)]:
                    del self._queued[k]
                self._queued.update(fresh)
            else:
                self._queued = fresh

    def set_draining(self, model: str, draining: bool = True):
        """Raise/clear a model's drain flag: a draining model's resources
        take no new placements (retries and speculation included)."""
        with self._lock:
            if draining:
                self._draining.add(model)
            else:
                self._draining.discard(model)

    def is_draining(self, model: str) -> bool:
        with self._lock:
            return model in self._draining

    def _usable(self, available: Sequence[str]) -> Sequence[str]:
        """Filter a candidate resource list through the drain flags (the
        no-drain fast path returns the input untouched).  Callers already
        hold ``_lock``; the re-entrant acquire here keeps the invariant
        local instead of relying on the call graph."""
        with self._lock:
            if not self._draining:
                return available
            return [r for r in available
                    if (self.resources.get(r) is None
                        or self.resources[r].model not in self._draining)]

    def schedule(self, job: JobDescription, available: Sequence[str],
                 remote_paths: RemotePaths) -> Optional[str]:
        with self._lock:
            resource = self.policy.get_resource(
                job, self._usable(available), remote_paths, self.jobs,
                self.resources)
            if resource is None:
                return None
            self.jobs[job.name] = JobAllocation(job, resource)
            self.resources[resource].jobs.append(job.name)
            return resource

    def order_queue(self, queue: List[JobDescription],
                    remote_paths: RemotePaths) -> List[JobDescription]:
        hook = getattr(self.policy, "order_queue", None)
        if hook is None:
            return queue
        with self._lock:
            return hook(queue, remote_paths, self.resources)

    def schedule_batch(self, queue: Sequence[JobDescription],
                       available: Dict[str, Sequence[str]],
                       remote_paths: RemotePaths
                       ) -> List[Tuple[JobDescription, str]]:
        """Place as much of the ready queue as resources allow, atomically.

        ``available`` maps job name -> resources its service exposes.  A
        policy with a ``select_batch`` hook sees the whole queue at once;
        otherwise jobs are placed one-by-one in (optionally reordered)
        queue order, each placement visible to the next ``get_resource``
        call.  Returns committed (job, resource) pairs; unplaced jobs
        simply stay in the executor's waiting queue."""
        with self._lock:
            if self._draining:
                available = {name: self._usable(res)
                             for name, res in available.items()}
            select = getattr(self.policy, "select_batch", None)
            if select is not None:
                picked = select(list(queue), available, remote_paths,
                                self.jobs, self.resources)
            else:
                hook = getattr(self.policy, "order_queue", None)
                ordered = (hook(list(queue), remote_paths, self.resources)
                           if hook else list(queue))
                picked = []
                for job in ordered:
                    resource = self.policy.get_resource(
                        job, available.get(job.name, ()), remote_paths,
                        self.jobs, self.resources)
                    if resource is not None:
                        picked.append((job, resource))
                        # commit immediately so the next job sees it taken
                        self.jobs[job.name] = JobAllocation(job, resource)
                        self.resources[resource].jobs.append(job.name)
                return picked
            # commit select_batch's placements
            for job, resource in picked:
                self.jobs[job.name] = JobAllocation(job, resource)
                self.resources[resource].jobs.append(job.name)
            return picked

    def notify(self, job_name: str, status: JobStatus):
        with self._lock:
            alloc = self.jobs.get(job_name)
            if alloc is None:
                return
            alloc.status = status
            if status in (JobStatus.COMPLETED, JobStatus.FAILED):
                res = self.resources.get(alloc.resource)
                if res and job_name in res.jobs:
                    res.jobs.remove(job_name)

    def export_state(self, running_only: bool = False) -> SchedulerSnapshot:
        """Typed snapshot of job allocations + resource occupancy —
        ``.to_dict()`` is journaled by the executor so a crashed driver's
        scheduling state is inspectable, and the same object is the
        Autoscaler's control input (queue depth, running counts, drain
        flags).  ``running_only`` drops finished allocations, bounding
        the snapshot by scheduling width instead of workflow length (the
        executor journals one snapshot per completion, so the full history
        would make the journal grow quadratically)."""
        with self._lock:
            jobs = {name: {"resource": a.resource, "status": a.status.value}
                    for name, a in self.jobs.items()
                    if not running_only or a.status is JobStatus.RUNNING}
            resources = {name: {"model": r.model, "service": r.service,
                                "jobs": list(r.jobs)}
                         for name, r in self.resources.items()}
            queue_depth: Dict[str, int] = {}
            service_depth: Dict[str, int] = {}
            for _name, (service, models) in self._queued.items():
                service_depth[service] = service_depth.get(service, 0) + 1
                for m in models:
                    queue_depth[m] = queue_depth.get(m, 0) + 1
            running: Dict[str, int] = {}
            for a in self.jobs.values():
                if a.status is not JobStatus.RUNNING:
                    continue
                res = self.resources.get(a.resource)
                if res is not None:
                    running[res.model] = running.get(res.model, 0) + 1
            return SchedulerSnapshot(
                jobs=jobs, resources=resources, queue_depth=queue_depth,
                service_queue_depth=service_depth, running=running,
                draining=tuple(sorted(self._draining)))

    def export_capacity(self) -> Dict[Tuple[str, str], int]:
        """Registered resource slots per (model, service) — the live
        capability view.  The plan-time analyzer substitutes this for the
        declared replica counts when a document is submitted against an
        already-deployed pool, so its satisfiability proofs reflect what
        is actually registered rather than what the YAML promises."""
        with self._lock:
            out: Dict[Tuple[str, str], int] = {}
            for r in self.resources.values():
                key = (r.model, r.service)
                out[key] = out.get(key, 0) + 1
            return out

    def has_running(self) -> bool:
        """Any allocation still RUNNING, across every run sharing this
        scheduler — the executor's deadlock guard consults it so another
        run's jobs holding every resource reads as contention, not
        deadlock."""
        with self._lock:
            return any(a.status is JobStatus.RUNNING
                       for a in self.jobs.values())

    def running_on(self, model: str) -> List[str]:
        with self._lock:
            return [j for j, a in self.jobs.items()
                    if a.status is JobStatus.RUNNING
                    and self.resources.get(a.resource)
                    and self.resources[a.resource].model == model]
