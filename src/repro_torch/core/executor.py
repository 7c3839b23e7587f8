"""StreamFlow executor: the event loop driving a workflow across sites.

The unit of dispatch is the **invocation**, not the declared step: the
workflow is expanded (``Workflow.expand``) into an ``InvocationPlan``
before execution, so a step scattered over an N-element port stream
becomes N independently scheduled, routed and journaled invocations —
and a binding with multiple ``targets`` lets one scatter spread its
invocations across sites, each placement decided per invocation by the
Scheduler.  Scalar workflows expand to themselves (same paths, same
token refs), so everything below reads the same for the paper's flat
DAGs.

Two dispatch modes share one loop body:

``pipelined=True`` (default, beyond-paper): an event-driven pipelined
executor.  Per tick the *whole* ready queue is handed to the Scheduler
(``schedule_batch``) so queue-aware policies (backfill, locality-batch,
widest-first) see every fireable step before any placement commits; input
tokens for placed steps move asynchronously through the DataManager
(per-token in-flight dedup) so token movement for step N+1 overlaps compute
of step N; steps that could not get a worker slot have their inputs
*staged in* to the target site ahead of time, so the expensive cross-site
hop is already paid when a slot frees.  Completion callbacks wake the loop
instead of sleep-polling, and retry backoff is deferred (never blocks
dispatch of unrelated work).

``pipelined=False``: the paper's serialized FCFS loop (§4.4/§4.5), kept as
the measured baseline — one ``Scheduler.schedule`` call per queued step,
synchronous transfers inside the worker, sleep-polling.  Used by
``benchmarks/bench_pipeline.py`` to quantify the pipelining win.

Per iteration (both modes):
  1. fireable steps (all input tokens available) join the waiting queue;
  2. each queued step resolves its binding (deepest path wins), lazily
     deploys its model (R1), and asks the Scheduler for a resource;
  3. scheduled steps get their input tokens moved in by the DataManager
     (R4 elision / intra-model channel / R3 two-step) and run on a worker
     thread via the Connector;
  4. completions register output tokens and wake the queue; failures retry
     with backoff (re-deploying dead sites); long-runners may spawn a
     speculative twin (first finisher wins).

On success final outputs are collected to the management node; models are
undeployed at the end — and on any unhandled exception (paper §4.5).

With a ``checkpoint`` configured, every state transition is written ahead
to an execution journal (``persistence.py``) and ``resume(journal_path)``
recovers a crashed run: journaled-complete steps whose output tokens are
still reachable (verified through the Connector) are skipped, and only the
lost frontier re-executes.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor, Future
from concurrent.futures import wait as futures_wait
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.autoscale import AutoscaleConfig, Autoscaler
from repro_torch.core.connector import deserialize, serialize
from repro_torch.core.datamanager import DataManager
from repro_torch.core.deployment import DeploymentManager, ModelSpec
from repro_torch.core.events import (EventStream, InvocationStateChanged,
                               RunCancelled, TokenAvailable,
                               WorkflowCancelled, WorkflowCompleted,
                               WorkflowEvent, WorkflowFailed,
                               WorkflowStarted)
from repro_torch.core.fault import DurationTracker, FaultConfig
from repro_torch.core.persistence import (CacheConfig, CheckpointConfig,
                                    ExecutionJournal, InvocationCache,
                                    JournalError, JournalState,
                                    invocation_memo_key)
from repro_torch.core.scheduler import (JobDescription, JobStatus, POLICIES,
                                  Scheduler)
from repro_torch.core.streamflow_file import Binding, StreamFlowConfig
from repro_torch.core.topology import TopologyGraph
from repro_torch.core.workflow import (InvocationPlan, Workflow,
                                 invocation_base, match_binding,
                                 parse_token_ref)


@dataclass
class JobEvent:
    step: str
    model: str
    resource: str
    start: float
    end: float
    attempt: int
    status: str
    speculative: bool = False
    # recording order (assigned by _record): the stable tiebreak for
    # timeline_rows — equal-start events otherwise sort non-deterministically
    seq: int = -1


@dataclass
class RunResult:
    outputs: Dict[str, Any]
    events: List[JobEvent]
    transfers: List
    deployment_timeline: List[tuple]
    wall_seconds: float
    # work lost to planned preemption (attempts that died because their
    # site was revoked mid-step): the autoscale benchmark's wasted-work
    # ratio is wasted_seconds over total busy seconds
    wasted_seconds: float = 0.0
    wasted_invocations: int = 0

    def timeline_rows(self) -> List[tuple]:
        t0 = min((e.start for e in self.events), default=0.0)
        return [(e.step, e.resource, round(e.start - t0, 4),
                 round(e.end - t0, 4), e.status, e.attempt, e.speculative)
                for e in sorted(self.events, key=lambda e: (e.start, e.seq))]


class _Command:
    """The Connector 'command': reads input tokens from the resource store,
    runs the invocation fn, writes outputs back.  ``step`` is a
    ``workflow.Invocation`` (or a plain Step duck-typing one); ``tag``
    keys fault injection."""

    def __init__(self, step, executor: "StreamFlowExecutor",
                 model: str, resource: str):
        self.step = step
        self.tag = step.path
        self._ex = executor
        self._model = model
        self._resource = resource

    def __call__(self, ctx) -> Dict[str, Any]:
        store = ctx["connector"].store(self._resource)
        # store keys carry the executor's namespace so concurrent runs
        # sharing a pooled site can't collide (or falsely R4-elide) on
        # identical token refs
        key = self._ex._store_key
        inputs = {port: deserialize(store.get(key(token)))
                  for port, token in self.step.inputs.items()}
        cancel = ctx["environment"].get("__cancel__")
        if cancel is not None and cancel.is_set():
            raise RuntimeError(f"{self.step.path} cancelled pre-start")
        outputs = self.step.fn(inputs, ctx) or {}
        missing = set(self.step.outputs) - set(outputs)
        if missing:
            raise RuntimeError(
                f"{self.step.path} did not produce tokens {sorted(missing)}")
        for token in self.step.outputs:
            store.put(key(token), serialize(outputs[token]))
        return outputs


class StreamFlowExecutor:
    def __init__(self, models: Dict[str, ModelSpec], *,
                 policy: str = "data_locality",
                 grace_period_s: Optional[float] = None,
                 fault: Optional[FaultConfig] = None,
                 max_workers: int = 16,
                 pipelined: bool = True,
                 transfer_workers: int = 8,
                 prefetch_depth: int = 8,
                 deadlock_timeout_s: float = 2.0,
                 checkpoint=None,
                 topology=None,
                 deployment=None,
                 scheduler=None,
                 namespace: str = "",
                 cache=None,
                 autoscale=None,
                 report_queue: bool = False):
        # deployment/scheduler: inject shared (service-owned) managers —
        # ``deployment`` may be a pooled lease façade; a shared
        # ``scheduler`` gives this run a true view of site occupancy
        # across concurrent runs.  ``namespace`` prefixes this run's
        # remote store keys and scheduler job names so concurrent runs on
        # shared sites can't collide.
        # checkpoint: CheckpointConfig | dict | journal-path str | None
        if isinstance(checkpoint, str):
            checkpoint = CheckpointConfig(journal_path=checkpoint)
        elif isinstance(checkpoint, dict):
            checkpoint = CheckpointConfig.from_dict(checkpoint)
        self.journal = ExecutionJournal.from_checkpoint(checkpoint)
        # cache: InvocationCache (service-shared) | CacheConfig | the raw
        # ``cache:`` block value (dict/bool) | index-path str | None.
        # None == disabled == the engine's exact pre-cache behaviour.
        if isinstance(cache, str):
            cache = CacheConfig(index_path=cache)
        if not isinstance(cache, (InvocationCache, type(None))):
            cache = InvocationCache.from_config(
                cache if isinstance(cache, CacheConfig)
                else CacheConfig.from_value(cache))
        self.cache: Optional[InvocationCache] = cache
        self._memo_keys: Dict[str, str] = {}   # invocation path -> memo key
        # topology: TopologyGraph | raw ``topology:`` block dict | None
        if isinstance(topology, dict):
            topology = (TopologyGraph.from_config(models, topology)
                        if topology else None)
        self.topology = topology
        if topology is not None and deployment is None:
            # the planner and the physical simulation must agree: push the
            # graph's management star costs down into each model's config,
            # where Connector.copy pays them on management-relay hops.
            # Work on copies — the caller's ModelSpecs must not inherit
            # this executor's WAN model (a control run built from the same
            # dict would silently pay the treatment run's star costs).
            models = {name: ModelSpec(s.name, s.type, dict(s.config),
                                      s.external)
                      for name, s in models.items()}
            for name, spec in models.items():
                mgmt = topology.mgmt_link(name)
                if mgmt.latency_s or mgmt.bandwidth_mbps:
                    spec.config.setdefault("link_latency_s", mgmt.latency_s)
                    spec.config.setdefault("link_bandwidth_mbps",
                                           mgmt.bandwidth_mbps)
        if deployment is not None:
            self.deployment = deployment
            if getattr(deployment, "journal", None) is None:
                deployment.journal = self.journal
        else:
            self.deployment = DeploymentManager(
                models, grace_period_s=grace_period_s, journal=self.journal)
        self._shared_scheduler = scheduler is not None
        if scheduler is not None:
            self.scheduler = scheduler
        else:
            # cost-weighted placement is a *direct*-mode feature: with
            # routing="management" the scheduler keeps the paper's binary
            # holder-match (the measured control stays the paper's control)
            self.scheduler = Scheduler(
                POLICIES[policy](),
                topology=(topology if topology is not None
                          and topology.routing == "direct" else None))
        self._ns = namespace
        self.data = DataManager(self.deployment, self.scheduler,
                                transfer_workers=transfer_workers,
                                journal=self.journal, topology=topology,
                                key_prefix=namespace,
                                # digest-aware zero-cost routing only when
                                # the cache is on: `cache: off` runs keep
                                # byte-identical transfer logs
                                content_routing=self.cache is not None)
        # autoscale: Autoscaler (service-shared) | AutoscaleConfig | raw
        # ``autoscale:`` block dict | None.  None/absent == no autoscaler
        # object at all == the exact static-pool behaviour (no queue
        # reporting, no replica sites, byte-identical journals).
        if isinstance(autoscale, dict):
            autoscale = AutoscaleConfig.from_dict(autoscale)
        if isinstance(autoscale, AutoscaleConfig):
            autoscale = Autoscaler(autoscale, self.deployment,
                                   self.scheduler, data=self.data,
                                   topology=topology, journal=self.journal)
        self.autoscaler: Optional[Autoscaler] = autoscale
        # report_queue: push this run's unplaced backlog into the shared
        # scheduler even without a run-local autoscaler (the service's
        # pool-level autoscaler consumes it)
        self._report_queue = report_queue or autoscale is not None
        self._wasted_seconds = 0.0
        self._wasted_invocations = 0
        self.fault = fault or FaultConfig()
        self.durations = DurationTracker()
        self.max_workers = max_workers
        self.pipelined = pipelined
        self.prefetch_depth = prefetch_depth
        self.deadlock_timeout_s = deadlock_timeout_s
        self.events: List[JobEvent] = []
        self._ev_lock = threading.Lock()
        self._ev_seq = 0
        self._wake = threading.Event()
        self._sink = None                  # EventSink while streaming
        self._cancel_requested = threading.Event()
        # test/ops hook: called as tick_hook(tick_index, completed_paths) at
        # the top of every loop iteration — crash-injection raises from here
        self.tick_hook: Optional[Callable[[int, set], None]] = None

    @classmethod
    def from_config(cls, cfg: StreamFlowConfig, **kw) -> "StreamFlowExecutor":
        kw.setdefault("checkpoint", cfg.checkpoint or None)
        kw.setdefault("policy", cfg.policy)
        kw.setdefault("grace_period_s", cfg.grace_period_s)
        kw.setdefault("fault", FaultConfig.from_dict(cfg.fault))
        kw.setdefault("topology", cfg.topology or None)
        kw.setdefault("cache", cfg.cache or None)
        kw.setdefault("autoscale", cfg.autoscale or None)
        return cls(cfg.models, **kw)

    # ------------------------------------------------------------------ utils
    def _resolve_binding(self, step_path: str, bindings: List[Binding]
                         ) -> Binding:
        best = match_binding(step_path, [b.step for b in bindings])
        if best is None:
            raise KeyError(f"no binding matches step {step_path}")
        for b in bindings:
            if b.step.rstrip("/") == best.rstrip("/") or b.step == best:
                return b
        raise KeyError(best)

    def _ensure_deployed(self, model: str):
        conn = self.deployment.deploy(model)
        # (re-)register this model's resources with the scheduler
        for svc in self._services_of(conn):
            for r in conn.get_available_resources(svc):
                info = conn.resource_info(r)
                self.scheduler.register_resource(
                    r, model, svc, info.cores, info.memory_gb)
        return conn

    @staticmethod
    def _services_of(conn) -> List[str]:
        return conn.services()

    def _record(self, ev: JobEvent):
        with self._ev_lock:
            ev.seq = self._ev_seq
            self._ev_seq += 1
            self.events.append(ev)

    def _store_key(self, token: str) -> str:
        """Remote-store key for a token ref (namespaced per run)."""
        return self._ns + token

    def _sched_key(self, path: str) -> str:
        """Scheduler job name for an invocation path (namespaced per run
        so concurrent runs sharing a Scheduler can't collide)."""
        return self._ns + path

    def _emit(self, ev: WorkflowEvent):
        sink = self._sink
        if sink is not None:
            sink.emit(ev)

    def _transition(self, path: str, state: str, *, model=None,
                    resource=None, attempt: int = 0, error=None,
                    speculative: bool = False, memoized: bool = False):
        """One invocation state change: journaled (write-ahead) AND
        emitted on the live event stream.  Both dispatch loops go through
        here, which is what makes their event sequences identical."""
        if self.journal is not None and not speculative:
            kw = {}
            if model is not None:
                kw.update(model=model, resource=resource, attempt=attempt)
            if error is not None:
                kw["error"] = error
            if memoized:
                kw["memoized"] = True
            self.journal.step(path, state, **kw)
        if self._sink is not None:
            ev = InvocationStateChanged(
                path=path, state=state, model=model, resource=resource,
                attempt=attempt, speculative=speculative, error=error,
                memoized=memoized)
            self._emit(ev)

    # ------------------------------------------------------------------- run
    def run(self, workflow: Workflow, bindings: List[Binding],
            inputs: Optional[Dict[str, Any]] = None,
            collect: bool = True) -> RunResult:
        return self._execute(workflow, bindings, inputs, collect)

    def run_stream(self, workflow: Workflow, bindings: List[Binding],
                   inputs: Optional[Dict[str, Any]] = None,
                   collect: bool = True, *, buffer: int = 256,
                   sink=None) -> EventStream:
        """Execute on a background thread and return the live event
        stream.  Iterate it for typed events (the producer blocks when
        the consumer lags more than ``buffer`` events behind);
        ``.result()`` joins and returns the same RunResult ``run()``
        would have."""
        return EventStream(
            self, lambda: self._execute(workflow, bindings, inputs, collect),
            buffer=buffer, sink=sink)

    def resume_stream(self, journal_path: Optional[str] = None,
                      workflow: Optional[Workflow] = None,
                      bindings: Optional[List[Binding]] = None,
                      inputs: Optional[Dict[str, Any]] = None,
                      collect: bool = True, *, buffer: int = 256,
                      sink=None) -> EventStream:
        """``resume()`` as an event stream: journaled history replays as
        synthetic events (``replayed=True``) before the live ones."""
        return EventStream(
            self, lambda: self.resume(journal_path, workflow, bindings,
                                      inputs, collect),
            buffer=buffer, sink=sink)

    def cancel(self):
        """Request cooperative cancellation: in-flight invocations get
        their cancel flag set, never-started ones are journaled
        ``cancelled``, the journal gains a terminal ``run_cancelled``
        record (the run stays resumable), and ``_execute`` raises
        ``RunCancelled``."""
        self._cancel_requested.set()
        self._wake.set()

    # ---------------------------------------------------------------- resume
    def resume(self, journal_path: Optional[str] = None,
               workflow: Optional[Workflow] = None,
               bindings: Optional[List[Binding]] = None,
               inputs: Optional[Dict[str, Any]] = None,
               collect: bool = True) -> RunResult:
        """Recover a crashed run from its execution journal.

        Replays ``journal_path`` (defaults to this executor's configured
        journal), rebuilds the workflow and bindings from the journal when
        the caller doesn't pass them (possible whenever the original run
        came from a StreamFlow file), then:

          * restores the external input tokens from their journaled payloads;
          * for every journaled-complete step, verifies each output token is
            *still reachable* — an inline journal payload, or present in a
            live site's store, checked through the Connector (the journal is
            never trusted blindly: a dead site means the step re-runs);
          * registers the verified locations with the DataManager, marks
            fully-verified steps completed, and re-issues journaled
            in-flight transfers (idempotent via R4 elision + per-token
            dedup);
          * re-enters the normal execution loop, which fires only the lost
            frontier.

        Resuming an already-finished journal re-executes nothing and is
        idempotent.  All events of the resumed run append to the same
        journal, so a second crash resumes from strictly later state.
        """
        if journal_path is None:
            if self.journal is None:
                raise ValueError(
                    "resume() needs a journal_path (or an executor "
                    "constructed with checkpoint=...)")
            journal_path = self.journal.path
        state = ExecutionJournal.replay(journal_path)
        if workflow is None:
            workflow = state.build_workflow()
        if bindings is None:
            bindings = state.build_bindings()
            if not bindings:
                raise JournalError(
                    "journal holds no bindings; pass them to resume()")
        # the journal records the *expanded* per-invocation structure, so a
        # partially-completed scatter resumes invocation by invocation —
        # expansion is deterministic, hence paths and token refs line up
        plan = workflow.expand()
        state.check_structure(plan)
        # the resumed run must append to the WAL it replayed — a second
        # crash then resumes from strictly later state in the same file
        if self.journal is None or (os.path.abspath(self.journal.path)
                                    != os.path.abspath(journal_path)):
            # keep the durability policy: the executor's configured level,
            # else whatever the replayed WAL itself was written with
            opts = dict(state.journal_opts or {})
            if self.journal is not None:
                opts = dict(fsync=self.journal.fsync,
                            include_payloads=self.journal.include_payloads,
                            max_payload_bytes=self.journal.max_payload_bytes)
                self.journal.close()
            self.journal = ExecutionJournal(journal_path, **opts)
            self.deployment.journal = self.journal
            self.data.journal = self.journal

        explicit = dict(inputs or {})
        inputs = dict(explicit)
        for token, raw in state.input_payloads.items():
            if token not in inputs:
                inputs[token] = deserialize(raw)
        # journaled inputs are already durable; re-journal only overrides —
        # and taint everything downstream of a changed value, or completed
        # steps computed from the OLD input would silently be skipped and
        # the final outputs would mix the two input epochs
        changed: set = set()
        for token, value in explicit.items():
            raw = serialize(value)
            if state.input_payloads.get(token) != raw:
                self.journal.input(token, raw)
                if token in state.input_payloads:
                    changed.add(token)
        tainted = self._taint_downstream(plan, changed)
        state.completed_steps = {
            p for p in state.completed_steps
            if p in plan.steps and not (
                tainted & set(plan.steps[p].inputs.values()))}
        # purge stale replicas of tainted tokens from still-live sites, or
        # the R4 presence check would elide transfers onto old-epoch bytes
        for token in tainted:
            for model, resource, store_path in state.token_locations.get(
                    token, ()):
                try:
                    self.deployment.deploy(model).store(resource).delete(
                        store_path)
                except KeyError:
                    continue
        # in-flight transfer replay below needs its local sources in place
        # (the full input pass happens once, inside _execute)
        for token in {t for t, _, _ in state.transfers_inflight
                      if t in inputs}:
            self.data.put(token, inputs[token])

        pre_completed: set = set()
        pre_tokens: set = set()
        for path in state.completed_steps:
            step = plan.steps.get(path)
            if step is None:
                continue
            found = {t: self._verify_token(state, t) for t in step.outputs}
            if any(v is None for v in found.values()):
                continue        # output lost with its site: re-run the step
            # register only fully-verified steps — a half-lost step re-runs
            # and must not race its consumers against stale replicas
            for token, (how, what) in found.items():
                if how == "payload":
                    self.data.local_store.put(token, what)
                else:
                    model, resource, store_path = what
                    self.data.add_remote_path_mapping(model, resource,
                                                      token, store_path)
                pre_tokens.add(token)
            pre_completed.add(path)

        # streaming resume: journaled history becomes synthetic events
        # (replayed=True) ahead of the live ones, so a client attaching
        # after a crash still sees the whole story in order
        if self._sink is not None:
            started = WorkflowStarted(workflow=plan.name,
                                      invocations=len(plan.steps),
                                      resumed=True)
            self._emit(started)
            for path in sorted(pre_completed):
                st = state.steps.get(path)
                ev = InvocationStateChanged(
                    path=path, state="completed",
                    model=st.model if st else None,
                    resource=st.resource if st else None,
                    attempt=st.attempt if st else 0)
                ev.replayed = True
                self._emit(ev)
            for token in sorted(pre_tokens):
                port, tag = parse_token_ref(token)
                locs = state.token_locations.get(token, ())
                tok = TokenAvailable(token=token, port=port, tag=tag,
                                     model=locs[0][0] if locs else None,
                                     resource=locs[0][1] if locs else None)
                tok.replayed = True
                self._emit(tok)

        # replay copies that were in flight at the crash; dedup/elision make
        # re-issuing safe, and the run loop re-requests anything we skip
        for token, dst_model, dst_resource in sorted(state.transfers_inflight):
            if not (self.data.local_store.exists(token)
                    or self.data.locations(token)):
                continue
            try:
                self.deployment.deploy(dst_model)
                self.data.transfer(token, dst_model, dst_resource)
            except KeyError:
                continue        # model no longer configured: skip the replay

        return self._execute(plan, bindings, inputs, collect,
                             pre_completed=pre_completed,
                             pre_tokens=pre_tokens, resumed=True)

    @staticmethod
    def _taint_downstream(plan: InvocationPlan, changed: set) -> set:
        """Close a set of changed tokens over the DAG: any invocation
        consuming a tainted token taints all its outputs."""
        tainted = set(changed)
        grew = bool(changed)
        while grew:
            grew = False
            for step in plan.steps.values():
                if tainted & set(step.inputs.values()):
                    fresh = set(step.outputs) - tainted
                    if fresh:
                        tainted |= fresh
                        grew = True
        return tainted

    def _verify_token(self, state: JournalState, token: str):
        """Locate a journaled token that is still reachable.  Returns
        ("payload", raw_bytes), ("remote", (model, resource, store_path))
        for the first location the Connector confirms, or None."""
        raw = state.payloads.get(token)
        if raw is not None:
            return ("payload", raw)
        for model, resource, store_path in state.token_locations.get(
                token, ()):
            try:
                conn = self.deployment.deploy(model)
            except KeyError:
                continue        # model not in this executor's spec set
            if not conn.ping(resource):
                continue
            try:
                if conn.store(resource).exists(store_path):
                    return ("remote", (model, resource, store_path))
            except KeyError:
                continue        # resource gone from the (re)deployed site
        return None

    # ----------------------------------------------------- cross-run memoization
    def _memo_key_for(self, plan, path: str, step) -> Optional[str]:
        """Memo key of a fireable invocation: hash(command identity,
        resolved input digests, scatter tag).  The identity pins the
        workflow's builder reference (module/builder/args) — step fns are
        often closures whose qualname is identical across different
        builder args, so the args MUST salt the key."""
        digests: Dict[str, str] = {}
        for slot, token in step.inputs.items():
            d = self.data.token_digest(token)
            if d is None:
                return None     # input bytes unreachable: execute normally
            digests[slot] = d
        identity = {
            "workflow": plan.name,
            "builder": getattr(plan, "builder_info", None),
            "path": path,
            "outputs": list(step.outputs),
        }
        return invocation_memo_key(identity, digests,
                                   tuple(getattr(step, "tag", ())))

    def _verify_memo_output(self, meta: dict, memo_key: str
                            ) -> Optional[Tuple[str, str, str]]:
        """First recorded location of a cached output that still checks
        out: site in this run's model set, answering the liveness ping,
        and holding bytes that STILL hash to the recorded digest (the
        in-place-mutation recheck — a mismatch invalidates the entry).
        Returns (model, resource, store_path) or None."""
        for model, resource, store_path in meta.get("locs", ()):
            try:
                conn = self.deployment.deploy(model)
            except KeyError:
                continue        # model not in this executor's spec set
            if not conn.ping(resource):
                continue
            try:
                digest = conn.store(resource).digest_of(store_path)
            except KeyError:
                continue        # resource gone from the (re)deployed site
            if digest is None:
                continue        # store lost the payload (fresh deploy)
            if digest != meta.get("digest"):
                # the bytes under the recorded path changed in place —
                # the whole entry is untrustworthy, drop it
                self.cache.invalidate(memo_key)
                return None
            return (model, resource, store_path)
        return None

    def _try_memo(self, plan, path: str, completed: set,
                  done_tokens: set) -> bool:
        """Satisfy a fireable invocation from the cross-run cache.  On a
        verified hit every output is aliased (by digest, zero bytes) into
        this run's namespace, registered, and the invocation transitions
        straight to ``completed`` with ``memoized=True``.  Any doubt —
        missing digest, dead site, mutated payload — returns False and the
        invocation executes normally (the cache is an optimisation, never
        an authority)."""
        step = plan.steps[path]
        memo_key = self._memo_key_for(plan, path, step)
        if memo_key is None:
            return False
        entry = self.cache.lookup(memo_key)
        if entry is None:
            # remembered so _harvest can record this invocation's outputs
            # under the exact key its inputs hashed to
            self._memo_keys[path] = memo_key
            return False
        verified: Dict[str, Tuple[str, str, str, dict]] = {}
        for token in step.outputs:
            meta = entry["outputs"].get(token)
            loc = (self._verify_memo_output(meta, memo_key)
                   if meta is not None else None)
            if loc is None:
                self._memo_keys[path] = memo_key
                return False    # partial reuse is no reuse: execute
            verified[token] = (*loc, meta)
        now = time.time()
        for token, (model, resource, store_path, meta) in verified.items():
            conn = self.deployment.get_connector(model)
            # zero-cost CAS alias into THIS run's key: consumers read
            # their namespaced path, and the R4 presence check now holds
            conn.store(resource).link_digest(self._store_key(token),
                                             meta["digest"])
            self.data.add_remote_path_mapping(model, resource, token)
            self.data.journal_payload(token)
            done_tokens.add(token)
        completed.add(path)
        first_model, first_resource = verified[next(iter(step.outputs))][:2]
        # WAL ordering as in _harvest: tokens are durable before the
        # completed transition, so resume() re-verifies, never re-trusts
        self._transition(path, "completed", model=first_model,
                         resource=first_resource, memoized=True)
        for token in step.outputs:
            port, tag = parse_token_ref(token)
            self._emit(TokenAvailable(token=token, port=port, tag=tag,
                                      model=verified[token][0],
                                      resource=verified[token][1]))
        self._record(JobEvent(path, first_model, first_resource,
                              now, time.time(), 0, "memoized"))
        return True

    def _memo_record(self, plan, path: str, model: str, resource: str):
        """After a real execution, remember the invocation's outputs
        (digest + size + site location) under its memo key."""
        memo_key = self._memo_keys.pop(path, None)
        if memo_key is None:
            return
        conn = self.deployment.get_connector(model)
        if conn is None:
            return
        step = plan.steps[path]
        outputs: Dict[str, dict] = {}
        for token in step.outputs:
            store_path = self._store_key(token)
            try:
                store = conn.store(resource)
            except KeyError:
                return
            digest = store.digest_of(store_path)
            if digest is None:
                return          # output not where expected: don't memo
            outputs[token] = {"digest": digest,
                              "size": max(store.size(store_path), 0),
                              "locs": [(model, resource, store_path)]}
        self.cache.record(memo_key, path, outputs)

    def _execute(self, workflow, bindings: List[Binding],
                 inputs: Optional[Dict[str, Any]] = None,
                 collect: bool = True, *,
                 pre_completed: Optional[set] = None,
                 pre_tokens: Optional[set] = None,
                 resumed: bool = False) -> RunResult:
        t_start = time.time()
        # accepts a Workflow (expanded here) or an already-expanded plan
        # (resume passes one); scalar workflows expand to themselves —
        # same paths, same token refs — so pre-Port callers see no change
        plan: InvocationPlan = workflow.expand()
        inputs = inputs or {}
        missing = set(plan.external_inputs()) - set(inputs) \
            - set(pre_tokens or ())
        if missing:
            raise ValueError(f"missing workflow inputs: {sorted(missing)}")
        for token, value in inputs.items():
            self.data.put(token, value)
        if self.journal is not None:
            # a resumed run's inputs are already durable in this WAL
            # (resume() journals only overriding values)
            self.journal.begin_run(
                plan, bindings,
                {} if resumed else {t: serialize(v)
                                    for t, v in inputs.items()},
                resumed=resumed, scatter=plan.scatter_widths())
        if not resumed:
            # (a resumed run emitted its WorkflowStarted before replay)
            self._emit(WorkflowStarted(workflow=plan.name,
                                       invocations=len(plan.steps)))

        done_tokens = set(inputs) | set(pre_tokens or ())
        completed: set = set(pre_completed or ())
        self._memo_keys.clear()                # per-execution scratch state
        self._wasted_seconds = 0.0
        self._wasted_invocations = 0
        running: Dict[str, dict] = {}          # step path -> job record
        waiting: List[str] = []
        retries: List[dict] = []               # {rec, path, retry_at}
        failed_final: Dict[str, Exception] = {}

        pool = ThreadPoolExecutor(max_workers=self.max_workers)
        self._pool = pool
        self._wake.clear()
        starving_since: Optional[float] = None
        tick = 0
        try:
            while len(completed) < len(plan.steps):
                if self.tick_hook is not None:
                    self.tick_hook(tick, set(completed))
                tick += 1
                if self._cancel_requested.is_set():
                    # harvest first: work that finished before the cancel
                    # landed is journaled completed and stays resumable
                    self._harvest(running, completed, done_tokens,
                                  failed_final, retries)
                    self._cancel_run(plan, running, waiting, retries,
                                     completed)
                if failed_final:
                    step, err = next(iter(failed_final.items()))
                    raise RuntimeError(
                        f"step {step} failed after retries") from err
                # 1. enqueue newly fireable invocations (FCFS arrival order);
                #    with the cross-run cache on, an invocation whose memo
                #    entry verifies live is completed here and never queues
                started = (list(running) + list(completed) + waiting
                           + [r["path"] for r in retries])
                memoed = 0
                for path in plan.fireable(done_tokens, started):
                    if self.cache is not None and self._try_memo(
                            plan, path, completed, done_tokens):
                        memoed += 1
                        continue
                    waiting.append(path)
                    self._transition(path, "fireable")
                # 2. launch retries whose backoff deadline passed (a step
                # whose speculative twin finished during the backoff is
                # already complete — don't re-execute it)
                now = time.time()
                due, pending = [], []
                for r in retries:
                    if r["path"] in completed:
                        continue
                    (due if r["retry_at"] <= now else pending).append(r)
                retries = pending
                for r in due:
                    self._retry(r["rec"], r["path"], running)
                # 3. schedule the queue (whole-queue batch when pipelined)
                waiting = self._schedule_queue(
                    plan, bindings, waiting, running, pool)
                # 3b. autoscaling: export the unplaced backlog as queue
                #     pressure, then run one control iteration.  Entirely
                #     absent without an autoscaler/service — the static
                #     pool's scheduling is untouched.
                if self._report_queue:
                    self.scheduler.note_queue(
                        self._queue_entries(waiting, bindings), ns=self._ns)
                if self.autoscaler is not None:
                    self.autoscaler.tick()
                # 4. straggler speculation
                if self.fault.speculative:
                    self._maybe_speculate(plan, bindings, running, pool)
                # 5. harvest completions (failures defer into ``retries``)
                progressed = self._harvest(running, completed, done_tokens,
                                           failed_final, retries)
                # 6. grace-period undeploy (beyond-paper)
                pending = waiting + list(running) + [r["path"]
                                                    for r in retries]
                pending_models = set()
                for p in pending:
                    b = self._resolve_binding(p.split("#spec")[0], bindings)
                    pending_models.update(m for m, _ in b.targets)
                released = self.deployment.maybe_undeploy_idle(pending_models)
                for m in released:
                    self.scheduler.forget_model(m)
                    self.data.drop_model(m)
                    if self.cache is not None:
                        self.cache.drop_model(m)
                # 7. progress bookkeeping: sleep on the wake event (pipelined)
                #    or poll (serialized baseline); deadlock guard either way
                #    (a memo hit is progress: its tokens may fire successors
                #    immediately, so don't sleep on them)
                if progressed or due or memoed:
                    starving_since = None
                    continue
                if waiting and not running and not retries:
                    # under a shared scheduler, resources busy with OTHER
                    # runs' jobs are contention, not deadlock — keep waiting
                    # while anything is running anywhere
                    if self._shared_scheduler and self.scheduler.has_running():
                        starving_since = None
                    else:
                        starving_since = starving_since or time.time()
                        if (time.time() - starving_since
                                > self.deadlock_timeout_s):
                            raise RuntimeError(
                                f"scheduling deadlock: waiting={waiting}, "
                                f"no resources accept them")
                else:
                    starving_since = None
                if self.pipelined:
                    timeout = 0.02
                    if retries:
                        soonest = min(r["retry_at"] for r in retries)
                        timeout = min(timeout,
                                      max(soonest - time.time(), 0.001))
                    self._wake.wait(timeout)
                    self._wake.clear()
                else:
                    time.sleep(0.003)

            # drain leftovers (surviving speculative twins / out-raced
            # primaries): their scheduler allocations and deployment job
            # counts must not leak past the run.  One bounded wait for the
            # lot; anything still running after it is abandoned (its result
            # can't matter — every step already completed) but released.
            if running:
                futures_wait([r["future"] for r in running.values()],
                             timeout=self.deadlock_timeout_s)
            for key, rec in list(running.items()):
                fut: Future = rec["future"]
                del running[key]
                self.deployment.job_finished(rec["model"])
                finished_clean = fut.done() and not fut.cancelled() \
                    and fut.exception() is None
                self.scheduler.notify(
                    self._sched_key(key), JobStatus.COMPLETED if finished_clean
                    else JobStatus.FAILED)
                self._record(JobEvent(key.split("#spec")[0],
                                      rec["model"], rec["resource"],
                                      rec["start"], time.time(),
                                      rec["attempt"],
                                      "duplicate" if finished_clean
                                      else "abandoned",
                                      rec["speculative"]))

            outputs = {}
            if collect:
                # stream ports collect element-wise into a tag-ordered list;
                # scalar ports keep the paper's flat token->value shape
                for port, refs in plan.output_ports().items():
                    if len(refs) == 1 and refs[0] == port:
                        outputs[port] = self.data.collect_output(port)
                    else:
                        outputs[port] = [self.data.collect_output(r)
                                         for r in refs]
            if self.journal is not None:
                self.journal.end_run(list(outputs))
            result = RunResult(outputs, list(self.events),
                               list(self.data.transfers),
                               list(self.deployment.timeline),
                               time.time() - t_start,
                               wasted_seconds=self._wasted_seconds,
                               wasted_invocations=self._wasted_invocations)
            self._emit(WorkflowCompleted(workflow=plan.name,
                                         outputs=dict(outputs),
                                         result=result))
            return result
        except BaseException as e:
            if not isinstance(e, RunCancelled):
                # (_cancel_run already emitted WorkflowCancelled)
                self._emit(WorkflowFailed(workflow=plan.name, error=str(e),
                                          error_type=type(e).__name__))
            self.deployment.undeploy_all()      # paper §4.5 exception path
            raise
        finally:
            if self.autoscaler is not None:
                self.autoscaler.shutdown()
            if self._report_queue:
                self.scheduler.note_queue([], ns=self._ns)
            pool.shutdown(wait=False, cancel_futures=True)
            self.data.close()
            self.deployment.undeploy_all()

    # ----------------------------------------------------------------- cancel
    def _cancel_run(self, plan, running, waiting, retries, completed):
        """The cancel flag landed: signal in-flight workers, give them one
        bounded wait (work that finishes in it is kept and journaled
        completed), release every allocation, journal never-started /
        interrupted invocations as ``cancelled`` plus the terminal
        ``run_cancelled`` record, and raise RunCancelled."""
        for rec in running.values():
            rec["cancel"].set()
        if running:
            futures_wait([r["future"] for r in running.values()],
                         timeout=self.deadlock_timeout_s)
        # abandoned workers (still not done after the wait): release them
        for key, rec in list(running.items()):
            fut: Future = rec["future"]
            if not fut.done():
                del running[key]
                path = key.split("#spec")[0]
                self.deployment.job_finished(rec["model"])
                self.scheduler.notify(self._sched_key(key), JobStatus.FAILED)
                self._record(JobEvent(path, rec["model"], rec["resource"],
                                      rec["start"], time.time(),
                                      rec["attempt"], "cancelled",
                                      rec["speculative"]))
                if not rec["speculative"] and path not in completed:
                    self._transition(path, "cancelled", model=rec["model"],
                                     resource=rec["resource"],
                                     attempt=rec["attempt"])
        # the rest finished during the wait — harvest normally so clean
        # completions register their tokens (failures land in ``retries``
        # and are folded into the cancelled set below)
        done_tokens: set = set()
        failed_final: Dict[str, Exception] = {}
        self._harvest(running, completed, done_tokens, failed_final, retries)
        cancelled = [p for p in dict.fromkeys(
            waiting + [r["path"] for r in retries] + list(failed_final))
            if p not in completed]
        for path in cancelled:
            self._transition(path, "cancelled")
        waiting.clear()
        retries.clear()
        pending = sorted(set(plan.steps) - set(completed))
        if self.journal is not None:
            self.journal.cancel_run(pending)
        self._emit(WorkflowCancelled(workflow=plan.name, pending=pending))
        raise RunCancelled(
            f"run cancelled with {len(pending)} invocation(s) incomplete")

    # --------------------------------------------------------------- schedule
    def _job_desc(self, plan, path: str, service: str) -> JobDescription:
        step = plan.steps[path]
        deps = {}
        for token in step.inputs.values():
            deps[token] = max(self.data.token_size(token), 1)
        return JobDescription(self._sched_key(path), step.requirements,
                              deps, service,
                              fanout=len(plan.successors(path)),
                              group=invocation_base(self._sched_key(path)),
                              tag=tuple(getattr(step, "tag", ())))

    def _avail_for(self, binding: Binding) -> List[str]:
        """Resources an invocation may land on: the union over the
        binding's targets (deploying each lazily).  One target keeps the
        paper's behaviour; multiple targets are what lets one scatter
        spread per-invocation across sites.

        Replica- and drain-aware: a target contributes every live
        autoscaled replica site alongside its base, and draining sites
        contribute nothing — retries and speculation route around a
        revoked replica instead of resurrecting it.  With no autoscaler
        the site list is exactly ``[model]`` and nothing drains, so the
        static-pool resource pool is unchanged."""
        pool: List[str] = []
        dep = self.deployment
        replicas_of = getattr(dep, "replicas_of", None)
        is_draining = getattr(dep, "is_draining", None)
        for model, service in binding.targets:
            sites = (replicas_of(model) if replicas_of is not None
                     else [model])
            for site in sites:
                if is_draining is not None and is_draining(site):
                    continue
                if site == model:
                    # replicas are deployed (and leased) by the
                    # autoscaler; only the base deploys lazily here
                    self._ensure_deployed(site)
                conn = dep.get_connector(site)
                if conn is None:
                    continue
                pool.extend(conn.get_available_resources(service))
        return pool

    def _placement_of(self, binding: Binding, resource: str
                      ) -> Tuple[str, str]:
        """(model, service) a scheduled resource belongs to."""
        alloc = self.scheduler.resources.get(resource)
        if alloc is not None:
            return alloc.model, alloc.service
        return binding.model, binding.service

    def _strip_ns(self, job_name: str) -> str:
        """Scheduler job name back to the invocation path."""
        return job_name[len(self._ns):] if self._ns else job_name

    def _queue_entries(self, waiting, bindings):
        """The unplaced backlog as (job, service, candidate models)
        triples — the autoscaler's queue-pressure input."""
        entries = []
        for p in waiting:
            b = self._resolve_binding(p, bindings)
            entries.append((self._sched_key(p), b.service,
                            [m for m, _ in b.targets]))
        return entries

    def _schedule_queue(self, plan, bindings, waiting, running, pool):
        if not waiting:
            return waiting
        descs: Dict[str, JobDescription] = {}
        avail: Dict[str, List[str]] = {}      # keyed by scheduler job name
        for p in waiting:
            b = self._resolve_binding(p, bindings)
            descs[p] = self._job_desc(plan, p, b.service)
            avail[self._sched_key(p)] = self._avail_for(b)
        if not self.pipelined:
            return self._schedule_serial(plan, bindings, waiting,
                                         descs, avail, running, pool)
        placed = self.scheduler.schedule_batch(
            [descs[p] for p in waiting], avail, self.data.remote_paths)
        placed_names = set()
        for job, resource in placed:
            path = self._strip_ns(job.name)
            self._launch(plan, path,
                         self._resolve_binding(path, bindings), resource,
                         running, pool, attempt=0, speculative=False)
            placed_names.add(path)
        still = [p for p in waiting if p not in placed_names]
        self._stage_in(plan, bindings, still,
                       {self._strip_ns(k): v for k, v in avail.items()})
        return still

    def _schedule_serial(self, plan, bindings, waiting, descs, avail,
                         running, pool):
        """The paper's loop: one Scheduler.schedule call per queued step."""
        order = self.scheduler.order_queue(
            [descs[p] for p in waiting], self.data.remote_paths)
        still = []
        for job in order:
            path = self._strip_ns(job.name)
            resource = self.scheduler.schedule(job, avail[job.name],
                                               self.data.remote_paths)
            if resource is None:
                still.append(path)
                continue
            self._launch(plan, path, self._resolve_binding(path, bindings),
                         resource, running, pool, attempt=0,
                         speculative=False)
        return still

    def _stage_in(self, plan, bindings, still: List[str],
                  avail: Dict[str, List[str]]):
        """Prefetch inputs of slot-starved steps onto their bound site so the
        cross-site hop is already paid when a worker slot frees (the
        follow-up move is an intra-model copy or an R4 elision).

        Candidates are ordered by the transfer planner's estimated route
        cost, most expensive first: with a bounded prefetch budget, the
        WAN hops worth prepaying beat the near-free LAN moves (which cost
        nothing at schedule time anyway).  Multi-target bindings stage
        toward the target the planner scores cheapest — the same argmin a
        cost-weighted placement would pick."""
        ranked: List[tuple] = []      # (-est_cost, queue_pos, path, tokens)
        for pos, path in enumerate(still):
            b = self._resolve_binding(path, bindings)
            if not avail.get(path):
                continue
            step = plan.steps[path]
            best = None               # (est, model, tokens)
            for model, _service in b.targets:
                tokens, est = [], 0.0
                for t in step.inputs.values():
                    if self.data.has_replica(t, model):
                        continue
                    # a token whose holder died has no source until the
                    # retry machinery recomputes it — don't spam the pool
                    # with copies doomed to fail
                    if not (self.data.local_store.exists(t)
                            or self.data.locations(t)):
                        continue
                    tokens.append(t)
                    est += self.data.estimate_cost(t, model)
                if best is None or est < best[0]:
                    best = (est, model, tokens)
            if best and best[2] and best[0] > 0:
                ranked.append((-best[0], pos, path, best[1], best[2]))
        ranked.sort(key=lambda r: r[:2])
        for _, _, path, model, tokens in ranked[:self.prefetch_depth]:
            # the exact resource doesn't matter: once any replica is on the
            # site, the schedule-time move is an intra-model copy (LAN) or
            # an R4 elision — the WAN hop is what stage-in prepays
            targets = [r for r in avail[path]
                       if self._placement_of_model(r) == model]
            if not targets:
                continue
            for token in tokens:
                self.data.transfer(token, model, targets[0])

    def _placement_of_model(self, resource: str) -> Optional[str]:
        alloc = self.scheduler.resources.get(resource)
        return alloc.model if alloc is not None else None

    def _launch(self, plan, path, binding, resource, running, pool,
                *, attempt: int, speculative: bool):
        step = plan.steps[path]
        model, service = self._placement_of(binding, resource)
        cancel = threading.Event()
        rec = {
            "binding": binding, "resource": resource, "attempt": attempt,
            "model": model, "service": service,
            "speculative": speculative, "cancel": cancel,
            "start": time.time(), "workflow": plan,
        }
        key = path if not speculative else f"{path}#spec{attempt}"
        running[key] = rec
        self.deployment.job_started(model)
        self._transition(path, "scheduled", model=model, resource=resource,
                         attempt=attempt, speculative=speculative)
        tokens = list(step.inputs.values())
        # pipelined: transfers start NOW, concurrent with other steps'
        # compute; the worker only joins the futures
        xfer_futs = (self.data.prefetch(tokens, model, resource)
                     if self.pipelined else None)

        def work():
            self._transition(path, "running", model=model,
                             resource=resource, attempt=attempt,
                             speculative=speculative)
            if xfer_futs is None:
                for token in tokens:            # serialized baseline (R3/R4)
                    self.data.transfer_sync(token, model, resource)
            else:
                for f in xfer_futs:
                    f.result()                  # propagate transfer failures
            conn = self.deployment.get_connector(model)
            cmd = _Command(step, self, model, resource)
            conn.run(resource, cmd, environment={"__cancel__": cancel},
                     capture_output=False)
            return None

        fut = pool.submit(work)
        rec["future"] = fut
        fut.add_done_callback(lambda _f: self._wake.set())

    # ---------------------------------------------------------------- harvest
    def _harvest(self, running, completed, done_tokens, failed_final,
                 retries: List[dict]) -> bool:
        progressed = False
        for key in list(running):
            rec = running[key]
            fut: Future = rec["future"]
            if not fut.done():
                continue
            progressed = True
            del running[key]
            path = key.split("#spec")[0]
            model, service = rec["model"], rec["service"]
            self.deployment.job_finished(model)
            err = fut.exception()
            now = time.time()
            plan = rec["workflow"]
            step = plan.steps[path]
            if err is None and path in completed:
                # lost the speculation race — record and move on
                # (notify under the key the allocation was registered with:
                # twins register as "path#specN", not "path")
                self.scheduler.notify(self._sched_key(key),
                                      JobStatus.COMPLETED)
                self._record(JobEvent(path, model, rec["resource"],
                                      rec["start"], now, rec["attempt"],
                                      "duplicate", rec["speculative"]))
                continue
            if err is None:
                is_draining = getattr(self.deployment, "is_draining", None)
                if (is_draining is not None and is_draining(model)
                        and not self.deployment.is_deployed(model)):
                    # completed on a site revoked mid-flight: the machine
                    # (and every output it holds) is already gone, so the
                    # result cannot be trusted — discard, drop its token
                    # locations, and retry on a surviving site.  Planned
                    # preemption never counts against the retry budget.
                    self._wasted_seconds += now - rec["start"]
                    self._wasted_invocations += 1
                    self.data.drop_model(model)
                    self.scheduler.forget_model(model)
                    self.scheduler.notify(self._sched_key(key),
                                          JobStatus.FAILED)
                    self._record(JobEvent(path, model, rec["resource"],
                                          rec["start"], now, rec["attempt"],
                                          "preempted", rec["speculative"]))
                    if rec["speculative"] or path in completed:
                        continue
                    retries.append({"rec": rec, "path": path,
                                    "retry_at": now})
                    continue
                completed.add(path)
                for token in step.outputs:
                    self.data.add_remote_path_mapping(
                        model, rec["resource"], token)
                    self.data.journal_payload(token)
                    done_tokens.add(token)
                if self.cache is not None:
                    self._memo_record(plan, path, model, rec["resource"])
                # WAL ordering: "completed" is written only after every
                # output token's location (and optional payload) is durable,
                # so a journaled-complete step always has journaled tokens
                # journaled even for a speculative winner — the twin's
                # completion IS the step's completion
                self._transition(path, "completed", model=model,
                                 resource=rec["resource"],
                                 attempt=rec["attempt"])
                for token in step.outputs:
                    port, tag = parse_token_ref(token)
                    self._emit(TokenAvailable(
                        token=token, port=port, tag=tag, model=model,
                        resource=rec["resource"]))
                self.durations.record(service, now - rec["start"])
                self.scheduler.notify(self._sched_key(key),
                                      JobStatus.COMPLETED)
                self._record(JobEvent(path, model, rec["resource"],
                                      rec["start"], now, rec["attempt"],
                                      "completed", rec["speculative"]))
                # cancel a surviving twin
                for k2, r2 in list(running.items()):
                    if k2.split("#spec")[0] == path:
                        r2["cancel"].set()
                continue
            # ---- failure path ------------------------------------------------
            self._transition(path, "failed", model=model,
                             resource=rec["resource"],
                             attempt=rec["attempt"],
                             error=type(err).__name__,
                             speculative=rec["speculative"])
            if self.journal is not None and not rec["speculative"]:
                # job-state export on the crash-relevant transition only:
                # diagnostics for a wedged/failing run, without paying an
                # extra fsync on every healthy completion
                self.journal.scheduler_state(
                    self.scheduler.export_state(running_only=True))
            self.scheduler.notify(self._sched_key(key), JobStatus.FAILED)
            self._record(JobEvent(path, model, rec["resource"],
                                  rec["start"], now, rec["attempt"],
                                  f"failed:{type(err).__name__}",
                                  rec["speculative"]))
            if rec["speculative"] or path in completed:
                continue                        # twin death is harmless
            if rec["attempt"] >= self.fault.max_retries:
                failed_final[path] = err
                continue
            # site health check: dead site => redeploy + forget its tokens
            conn = self.deployment.get_connector(model)
            if conn is None or not conn.ping(rec["resource"]):
                is_draining = getattr(self.deployment, "is_draining", None)
                drained = is_draining is not None and is_draining(model)
                self.data.drop_model(model)
                self.scheduler.forget_model(model)
                if self.cache is not None:
                    # the redeployed site comes back with empty stores:
                    # every cached location on it is now a lie
                    self.cache.drop_model(model)
                if drained:
                    # planned drain/preemption, not a crash: never
                    # resurrect the revoked site — the retry routes to
                    # surviving replicas via _avail_for.  The dead
                    # attempt is the preemption's wasted work.
                    self._wasted_seconds += now - rec["start"]
                    self._wasted_invocations += 1
                else:
                    self.deployment.redeploy(model)
            delay = self.fault.backoff_s * (
                self.fault.backoff_mult ** rec["attempt"])
            # defer instead of sleeping: backoff must not block dispatch of
            # unrelated ready work under concurrent execution
            retries.append({"rec": rec, "path": path,
                            "retry_at": now + delay})
        return progressed

    def _retry(self, rec, path, running):
        plan = rec["workflow"]
        b = rec["binding"]
        avail = self._avail_for(b)              # any target may host a retry
        job = self._job_desc(plan, path, b.service)
        job.name = self._sched_key(path)
        resource = self.scheduler.schedule(job, avail, self.data.remote_paths)
        if resource is None and avail:
            resource = avail[0]                 # retry may oversubscribe
            self.scheduler.jobs.pop(self._sched_key(path), None)
        if resource is None:
            raise RuntimeError(f"no resource to retry {path}")
        self._launch(plan, path, b, resource, running, self._pool,
                     attempt=rec["attempt"] + 1, speculative=False)

    # ------------------------------------------------------------- speculation
    def _maybe_speculate(self, plan, bindings, running, pool):
        for key, rec in list(running.items()):
            if rec["speculative"] or "#spec" in key:
                continue
            path = key
            b = rec["binding"]
            elapsed = time.time() - rec["start"]
            if not self.durations.is_straggler(rec["service"], elapsed,
                                               self.fault):
                continue
            if any(k.startswith(path + "#spec") for k in running):
                continue                        # one twin at a time
            avail = [r for r in self._avail_for(b) if r != rec["resource"]]
            if not avail:
                continue
            job = self._job_desc(plan, path, b.service)
            job.name = self._sched_key(f"{path}#spec{rec['attempt']}")
            resource = self.scheduler.schedule(job, avail,
                                               self.data.remote_paths)
            if resource is None:
                continue
            self._launch(plan, path, b, resource, running, pool,
                         attempt=rec["attempt"], speculative=True)
