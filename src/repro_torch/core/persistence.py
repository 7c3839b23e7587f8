"""Execution journal + crash recovery (beyond-paper, flagged).

The paper's management node is a single point of failure: when the driver
dies mid-run, every completed step's work is lost even though its output
tokens still sit on the remote sites (§4.5-§4.6).  This module closes that
gap with a *write-ahead execution journal*: an append-only JSON-lines file
(dependency-free, one fsync'd record per event) that captures everything
the driver would need to pick a run back up:

  run_begin    workflow structure (the *expanded* per-invocation graph,
               plus declared-step scatter widths), bindings, builder
               reference (module/builder/args, when the workflow came
               from a StreamFlow file) and the external input payloads;
  step         per-invocation state transitions
               (fireable -> scheduled -> running -> completed/failed) —
               a scattered step journals one state machine per element
               ("/count@3"), which is what makes a partial scatter
               individually recoverable;
  token        output-token registrations with their site locations
               (model, resource, store path) and, for scatter-stream
               elements, their tag;
  payload      optional inline copies of small output tokens, so recovery
               works even when every site died with the driver;
  transfer     start/done markers for data movements, so in-flight copies
               can be replayed idempotently on resume;
  deployment   model lifecycle events (deploy/attach/undeploy/redeploy);
  drop_model   site-death invalidations of journaled token locations;
  scheduler    job-state snapshots (Scheduler.export_state);
  run_end      terminal marker with the collected output tokens.

Recovery is *re-execution from the journaled frontier*, the strategy of
production StreamFlow: ``Executor.resume`` replays the journal, verifies
that each journaled-complete step's output tokens are still reachable
(asking the Connector — the journal is a hint, never trusted blindly),
skips verified steps, and re-fires only the lost frontier.  A truncated or
corrupt journal *tail* (the record being written when the driver died) is
dropped, not fatal; corruption in the middle of the file is an error.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple


class JournalError(ValueError):
    """Raised for unusable journals (corruption before the tail)."""


@dataclass
class CheckpointConfig:
    """The ``checkpoint:`` block of a StreamFlow file."""
    enabled: bool = True
    journal_path: str = ".streamflow/journal.jsonl"
    fsync: bool = True
    # journal output payloads inline (<= max_payload_bytes each) so resume
    # survives even total site loss; off by default — the paper's sites keep
    # the tokens, the journal only has to remember where they are
    include_payloads: bool = False
    max_payload_bytes: int = 1 << 20

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["CheckpointConfig"]:
        if not d:
            return None
        unknown = set(d) - set(cls.__dataclass_fields__)
        if unknown:         # a typo'd key must not silently misconfigure
            raise ValueError(
                f"unknown checkpoint key(s) {sorted(unknown)}; "
                f"known: {sorted(cls.__dataclass_fields__)}")
        cfg = cls(**d)
        return cfg if cfg.enabled else None


@dataclass
class _StepState:
    state: str = "fireable"
    model: Optional[str] = None
    resource: Optional[str] = None
    attempt: int = 0


@dataclass
class JournalState:
    """Aggregate view of a replayed journal."""
    workflow_name: Optional[str] = None
    journal_opts: Optional[dict] = None       # durability policy of the WAL
    # invocation path -> {"inputs": {slot: ref}, "outputs": [ref, ...]}
    structure: Dict[str, dict] = field(default_factory=dict)
    # declared step path -> invocation count (scattered steps only)
    scatter_widths: Dict[str, int] = field(default_factory=dict)
    # token ref -> scatter tag (stream elements only)
    token_tags: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    builder: Optional[dict] = None            # {module, builder, args}
    bindings: List[Tuple[str, str, str]] = field(default_factory=list)
    input_payloads: Dict[str, bytes] = field(default_factory=dict)
    steps: Dict[str, _StepState] = field(default_factory=dict)
    completed_steps: Set[str] = field(default_factory=set)
    # token -> [(model, resource, store_path)], dead-site drops applied
    token_locations: Dict[str, List[Tuple[str, str, str]]] = \
        field(default_factory=dict)
    payloads: Dict[str, bytes] = field(default_factory=dict)
    deployments: Dict[str, str] = field(default_factory=dict)  # model -> last
    transfers_inflight: Set[Tuple[str, str, str]] = field(default_factory=set)
    # (token, dst_model, dst_resource) -> last journaled planner route
    transfer_routes: Dict[Tuple[str, str, str], str] = \
        field(default_factory=dict)
    scheduler_snapshot: Optional[dict] = None
    run_ended: bool = False
    # terminal cooperative cancel: the run stopped on purpose, with
    # ``cancelled_pending`` invocations never completed — still resumable
    cancelled: bool = False
    cancelled_pending: List[str] = field(default_factory=list)
    # sites revoked on purpose (planned drain/preempt); sticky across the
    # teardown's own undeploy/drop_model records, cleared by a re-deploy
    planned_drains: Set[str] = field(default_factory=set)
    dropped_tail_lines: int = 0

    @property
    def preempted_models(self) -> List[str]:
        """Sites revoked by a planned ``preempt`` (or ``drain``) and never
        re-deployed: resume must not re-place work onto them even if
        their token locations verify."""
        return sorted(self.planned_drains)

    def build_workflow(self):
        """Rebuild the Workflow from the journaled builder reference
        (module/builder/args — only present when the run came from a
        StreamFlow file; hand-built workflows must be passed to resume)."""
        if not self.builder:
            raise JournalError(
                "journal has no workflow builder reference; pass the "
                "Workflow object to resume() explicitly")
        import importlib

        from repro_torch.core.workflow import Workflow
        mod = importlib.import_module(self.builder["module"])
        fn = getattr(mod, self.builder.get("builder", "build_workflow"))
        wf = fn(**self.builder.get("args", {}))
        if not isinstance(wf, Workflow):
            raise JournalError(
                f"journaled builder returned {type(wf).__name__}")
        if self.builder.get("scatter"):
            # the run's scatter declarations came from the StreamFlow
            # file's scatter: block, not the builder — re-apply them or
            # the rebuilt plan would be the scalar one and check_structure
            # would (rightly) refuse to resume
            from repro_torch.core.streamflow_file import _apply_scatter_block
            _apply_scatter_block(self.workflow_name or "journaled", wf,
                                 self.builder["scatter"])
        return wf

    def build_bindings(self):
        from repro_torch.core.streamflow_file import Binding
        out = []
        for b in self.bindings:
            step, model, service = b[0], b[1], b[2]
            extra = tuple(tuple(t) for t in (b[3] if len(b) > 3 else ()))
            out.append(Binding(step, model, service, extra))
        return out

    def check_structure(self, workflow) -> None:
        """The journal describes a *specific* expanded DAG; resuming a
        different one (changed ports — or a changed scatter width, which
        renames invocations and token refs) would silently skip the wrong
        steps."""
        ours = {p: {"inputs": dict(s.inputs), "outputs": list(s.outputs)}
                for p, s in workflow.steps.items()}
        if self.structure and ours != self.structure:
            missing = sorted(set(self.structure) - set(ours))
            extra = sorted(set(ours) - set(self.structure))
            raise JournalError(
                f"workflow does not match the journaled structure "
                f"(journal-only steps: {missing}, new steps: {extra}, "
                f"or changed ports)")


def _b64(raw: bytes) -> str:
    return base64.b64encode(raw).decode("ascii")


def _unb64(s: str) -> bytes:
    return base64.b64decode(s.encode("ascii"))


class ExecutionJournal:
    """Append-only write-ahead log.  Every ``append`` is flushed (and by
    default fsync'd) before returning, so a record the caller saw written
    survives a driver crash an instant later."""

    def __init__(self, path: str, *, fsync: bool = True,
                 include_payloads: bool = False,
                 max_payload_bytes: int = 1 << 20):
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        self.fsync = fsync
        self.include_payloads = include_payloads
        self.max_payload_bytes = max_payload_bytes
        self._lock = threading.Lock()
        self._repair_torn_tail(path)
        self._fh = open(path, "a", encoding="utf-8")

    @staticmethod
    def _repair_torn_tail(path: str):
        """Records are written as single ``line + \\n`` writes, so a crash
        can only leave a *suffix-truncated* final line with no newline.
        Truncate it before appending — otherwise the resumed run's first
        record would concatenate onto the torn one, turning a harmless
        tail artifact into mid-file corruption no later resume survives."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        if size == 0:
            return
        block = 1 << 16
        with open(path, "r+b") as fh:
            fh.seek(-1, os.SEEK_END)
            if fh.read(1) == b"\n":
                return
            # scan backwards in blocks for the last newline — journals with
            # inline payloads can be large, and only the tail matters
            end = size
            while end > 0:
                start = max(0, end - block)
                fh.seek(start)
                chunk = fh.read(end - start)
                nl = chunk.rfind(b"\n")
                if nl != -1:
                    fh.truncate(start + nl + 1)
                    return
                end = start
            fh.truncate(0)                       # no newline at all

    @classmethod
    def from_checkpoint(cls, cfg: Optional[CheckpointConfig]
                        ) -> Optional["ExecutionJournal"]:
        if cfg is None:
            return None
        return cls(cfg.journal_path, fsync=cfg.fsync,
                   include_payloads=cfg.include_payloads,
                   max_payload_bytes=cfg.max_payload_bytes)

    # ---------------------------------------------------------------- write
    def append(self, kind: str, **fields):
        rec = {"v": 1, "t": time.time(), "kind": kind, **fields}
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            if self._fh.closed:
                return
            self._fh.write(line + "\n")
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())

    def close(self):
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    # typed helpers ---------------------------------------------------------
    def begin_run(self, workflow, bindings, input_payloads: Dict[str, bytes],
                  *, resumed: bool = False,
                  scatter: Optional[Dict[str, int]] = None):
        structure = {p: {"inputs": dict(s.inputs),
                         "outputs": list(s.outputs)}
                     for p, s in workflow.steps.items()}
        self.append("run_begin", workflow=workflow.name, structure=structure,
                    builder=getattr(workflow, "builder_info", None),
                    bindings=[
                        [b.step, b.model, b.service]
                        + ([[list(t) for t in b.extra_targets]]
                           if getattr(b, "extra_targets", ()) else [])
                        for b in bindings],
                    scatter=scatter or {},
                    resumed=resumed,
                    # persist the durability policy: a resume driven purely
                    # by the journal must keep writing at the same level
                    journal_opts={
                        "fsync": self.fsync,
                        "include_payloads": self.include_payloads,
                        "max_payload_bytes": self.max_payload_bytes})
        for token, raw in input_payloads.items():
            self.input(token, raw)

    def input(self, token: str, raw: bytes):
        """External input payloads are always journaled in full (they are
        what makes resume(journal_path) self-sufficient) — unlike *output*
        payloads, which are opt-in and size-capped (``payload``)."""
        self.append("input", token=token, payload=_b64(raw))

    def step(self, path: str, state: str, **kw):
        self.append("step", path=path, state=state, **kw)

    def token(self, token: str, model: str, resource: str, path: str,
              tag: Optional[List[int]] = None):
        """``tag`` is the token's scatter coordinates (stream elements
        only) — replayed into ``JournalState.token_tags`` so recovery
        tooling can see which slice of a partial scatter is durable."""
        fields = {} if not tag else {"tag": tag}
        self.append("token", token=token, model=model, resource=resource,
                    path=path, **fields)

    def payload(self, token: str, raw: bytes) -> bool:
        """Inline a token's bytes if the checkpoint policy allows it."""
        if not self.include_payloads or len(raw) > self.max_payload_bytes:
            return False
        self.append("payload", token=token, payload=_b64(raw))
        return True

    def transfer(self, token: str, dst_model: str, dst_resource: str,
                 state: str, route: Optional[str] = None):
        """``route`` is the planner's hop description (e.g. "hpc->cloud" or
        "hpc->mgmt->cloud") so a replayed journal shows *how* a routed
        transfer moved, not just where it went — resume re-issues it
        through the planner, which re-routes against the live topology."""
        fields = {} if route is None else {"route": route}
        self.append("transfer", token=token, dst_model=dst_model,
                    dst_resource=dst_resource, state=state, **fields)

    def deployment(self, model: str, event: str):
        """Site lifecycle marker.  Beyond deploy/undeploy/attach/detach,
        the autoscaler journals *planned* ``drain`` and ``preempt``
        events, so a replayed journal can tell a revoked preemptible
        site from a crash (older readers ignore unknown events)."""
        self.append("deployment", model=model, event=event)

    def drop_model(self, model: str):
        self.append("drop_model", model=model)

    def scheduler_state(self, state):
        """Journal a scheduler snapshot: accepts the raw dict or any
        object with a ``to_dict()`` (``SchedulerSnapshot``)."""
        to_dict = getattr(state, "to_dict", None)
        if to_dict is not None:
            state = to_dict()
        self.append("scheduler", state=state)

    def end_run(self, outputs: List[str]):
        self.append("run_end", outputs=sorted(outputs))

    def cancel_run(self, pending: List[str]):
        """Terminal marker for a cooperative cancel: ``pending`` lists the
        never-completed invocation paths.  Unlike ``run_end`` this leaves
        the run resumable — ``Executor.resume`` re-fires exactly the
        pending frontier."""
        self.append("run_cancelled", pending=sorted(pending))

    # ----------------------------------------------------------------- read
    @staticmethod
    def replay(path: str) -> JournalState:
        """Parse a journal into an aggregate state.  Undecodable lines at
        the *tail* (the partial record a crash interrupted) are dropped;
        corruption followed by valid records means the file is damaged in a
        way a crash cannot explain, and raises."""
        if not os.path.exists(path):
            raise JournalError(f"no journal at {path}")
        records: List[dict] = []
        bad: List[int] = []
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            for i, line in enumerate(fh):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    if not isinstance(rec, dict) or "kind" not in rec:
                        raise ValueError("not a journal record")
                except ValueError:
                    bad.append(i)
                    continue
                if bad:
                    raise JournalError(
                        f"{path}: corrupt record at line {bad[0] + 1} is "
                        f"followed by valid records — not a crash artifact")
                records.append(rec)
        st = JournalState(dropped_tail_lines=len(bad))
        for rec in records:
            ExecutionJournal._apply(st, rec)
        if not st.structure and not st.steps:
            raise JournalError(f"{path}: journal holds no usable records")
        return st

    @staticmethod
    def _apply(st: JournalState, rec: dict):
        kind = rec["kind"]
        if kind == "run_begin":
            if not rec.get("resumed"):
                # a fresh run() on this journal starts a new execution
                # epoch: earlier runs' step/token state must not leak into
                # a resume of THIS run (resumed runs keep accumulating)
                st.steps.clear()
                st.completed_steps.clear()
                st.token_locations.clear()
                st.payloads.clear()
                st.input_payloads.clear()
                st.transfers_inflight.clear()
                st.scheduler_snapshot = None
            st.cancelled = False
            st.cancelled_pending = []
            st.workflow_name = rec.get("workflow")
            st.structure = rec.get("structure") or st.structure
            st.builder = rec.get("builder") or st.builder
            st.journal_opts = rec.get("journal_opts") or st.journal_opts
            st.scatter_widths = rec.get("scatter") or st.scatter_widths
            if rec.get("bindings"):
                st.bindings = [tuple(b) for b in rec["bindings"]]
            st.run_ended = False
        elif kind == "input":
            st.input_payloads[rec["token"]] = _unb64(rec["payload"])
        elif kind == "step":
            s = st.steps.setdefault(rec["path"], _StepState())
            s.state = rec["state"]
            s.model = rec.get("model", s.model)
            s.resource = rec.get("resource", s.resource)
            s.attempt = rec.get("attempt", s.attempt)
            if rec["state"] == "completed":
                st.completed_steps.add(rec["path"])
        elif kind == "token":
            locs = st.token_locations.setdefault(rec["token"], [])
            loc = (rec["model"], rec["resource"], rec["path"])
            if loc not in locs:
                locs.append(loc)
            if rec.get("tag"):
                st.token_tags[rec["token"]] = tuple(rec["tag"])
        elif kind == "payload":
            st.payloads[rec["token"]] = _unb64(rec["payload"])
        elif kind == "transfer":
            key = (rec["token"], rec["dst_model"], rec["dst_resource"])
            if rec.get("route"):
                st.transfer_routes[key] = rec["route"]
            if rec["state"] == "start":
                st.transfers_inflight.add(key)
            else:
                st.transfers_inflight.discard(key)
        elif kind == "deployment":
            st.deployments[rec["model"]] = rec["event"]
            if rec["event"] in ("preempt", "drain"):
                st.planned_drains.add(rec["model"])
            elif rec["event"] in ("deploy", "attach"):
                st.planned_drains.discard(rec["model"])
        elif kind == "drop_model":
            st.deployments[rec["model"]] = "dropped"
            for token in list(st.token_locations):
                st.token_locations[token] = [
                    l for l in st.token_locations[token]
                    if l[0] != rec["model"]]
            st.transfers_inflight = {
                k for k in st.transfers_inflight if k[1] != rec["model"]}
        elif kind == "scheduler":
            st.scheduler_snapshot = rec.get("state")
        elif kind == "run_end":
            st.run_ended = True
        elif kind == "run_cancelled":
            st.cancelled = True
            st.cancelled_pending = list(rec.get("pending", []))
        # unknown kinds are ignored: newer journals stay readable


# ---------------------------------------------------------------------------
# Cross-run invocation memoization (the ``cache:`` block)
# ---------------------------------------------------------------------------

@dataclass
class CacheConfig:
    """The ``cache:`` block of a StreamFlow file.

    ``scope`` decides who shares the memo index: ``service`` (the default)
    hands ONE index to every run a WorkflowService admits, so pooled
    tenants reuse each other's work; ``per-run`` gives each executor its
    own index at ``index_path`` (still persistent, so *re-runs* hit)."""
    enabled: bool = True
    index_path: str = ".streamflow/cache.jsonl"
    scope: str = "service"              # "service" | "per-run"
    fsync: bool = False                 # a cache may lose its tail safely

    def __post_init__(self):
        if self.scope not in ("service", "per-run"):
            raise ValueError(
                f"cache scope must be 'service' or 'per-run', "
                f"not {self.scope!r}")

    @classmethod
    def from_value(cls, v: Any) -> Optional["CacheConfig"]:
        """Normalize the StreamFlow file's ``cache:`` value.  Accepts the
        mapping form, plain booleans (YAML ``cache: off`` parses to
        False), or absence — anything disabled returns None, which is the
        engine's pre-cache behaviour switch."""
        if v is None or v is False or v == {}:
            return None
        if v is True:
            return cls()
        if not isinstance(v, dict):
            raise ValueError(f"cache: must be a mapping or a boolean, "
                             f"not {type(v).__name__}")
        unknown = set(v) - set(cls.__dataclass_fields__)
        if unknown:         # a typo'd key must not silently misconfigure
            raise ValueError(
                f"unknown cache key(s) {sorted(unknown)}; "
                f"known: {sorted(cls.__dataclass_fields__)}")
        cfg = cls(**v)
        return cfg if cfg.enabled else None


def invocation_memo_key(identity: dict, input_digests: Dict[str, str],
                        tag: Tuple[int, ...] = ()) -> str:
    """Memo key of one invocation: hash(step command identity, resolved
    input digests, scatter tag).  ``identity`` must pin everything that
    changes what the command computes (workflow/builder reference and
    args, step path, output ports) — input *values* arrive as content
    digests, so two runs feeding identical bytes hash identically however
    the bytes got there."""
    blob = json.dumps({"identity": identity,
                       "inputs": dict(sorted(input_digests.items())),
                       "tag": list(tag)},
                      sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


class InvocationCache:
    """Persistent cross-run invocation memo index (append-only JSONL).

    Each entry maps a memo key to the invocation's output tokens — their
    content digests, sizes and last-known site locations.  The cache is a
    *hint*, never trusted blindly: the executor re-verifies, per reuse,
    that a listed site still answers and that the payload at the listed
    path still hashes to the recorded digest (in-place mutation detection)
    before skipping an invocation.  Site death/redeploy invalidates
    eagerly via ``drop_model``.

    Record kinds: ``entry`` (add/overwrite), ``drop`` (invalidate one
    key), ``drop_model`` (a site died — strip its locations; entries left
    with an output that has no location anywhere are removed).  A torn or
    unreadable tail is skipped silently — losing cache entries only costs
    re-execution, never correctness."""

    def __init__(self, path: str, *, fsync: bool = False):
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        self.fsync = fsync
        self._lock = threading.Lock()
        # memo key -> {"step": path, "outputs": {ref: {"digest", "size",
        #              "locs": [[model, resource, store_path], ...]}}}
        self._entries: Dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        ExecutionJournal._repair_torn_tail(path)
        self._load(path)
        self._fh = open(path, "a", encoding="utf-8")

    def _load(self, path: str):
        if not os.path.exists(path):
            return
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue            # stale garbage: a cache may shed it
                if not isinstance(rec, dict):
                    continue
                self._apply(rec)

    def _apply(self, rec: dict):
        kind = rec.get("kind")
        if kind == "entry" and rec.get("key"):
            self._entries[rec["key"]] = {"step": rec.get("step", ""),
                                         "outputs": rec.get("outputs", {})}
        elif kind == "drop" and rec.get("key"):
            self._entries.pop(rec["key"], None)
        elif kind == "drop_model" and rec.get("model"):
            self._strip_model(rec["model"])

    def _strip_model(self, model: str):
        for key in list(self._entries):
            outputs = self._entries[key]["outputs"]
            dead = False
            for meta in outputs.values():
                meta["locs"] = [l for l in meta.get("locs", [])
                                if l[0] != model]
                dead = dead or not meta["locs"]
            if dead:
                del self._entries[key]

    def _append(self, rec: dict):
        line = json.dumps({"v": 1, "t": time.time(), **rec},
                          separators=(",", ":"))
        if self._fh.closed:
            return
        self._fh.write(line + "\n")
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    # ------------------------------------------------------------------ api
    def lookup(self, key: str) -> Optional[dict]:
        """The recorded outputs for a memo key, or None.  Returns a deep
        copy — callers (and their verification failures) must not mutate
        the index in place."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None
            self.hits += 1
            return json.loads(json.dumps(entry))

    def record(self, key: str, step: str, outputs: Dict[str, dict]):
        """Remember an invocation's outputs: ``outputs`` maps token ref ->
        {"digest", "size", "locs": [(model, resource, store_path), ...]}."""
        outputs = {ref: {"digest": m["digest"], "size": m["size"],
                         "locs": [list(l) for l in m["locs"]]}
                   for ref, m in outputs.items()}
        with self._lock:
            self._entries[key] = {"step": step, "outputs": outputs}
            self._append({"kind": "entry", "key": key, "step": step,
                          "outputs": outputs})

    def invalidate(self, key: str):
        """Drop one entry (digest recheck failed: in-place mutation)."""
        with self._lock:
            if self._entries.pop(key, None) is not None:
                self.invalidations += 1
                self._append({"kind": "drop", "key": key})

    def drop_model(self, model: str):
        """A site died or was redeployed: its stores are gone, so every
        location on it is a lie.  Entries that kept at least one location
        per output survive (another site still holds the artifact)."""
        with self._lock:
            before = len(self._entries)
            self._strip_model(model)
            self.invalidations += before - len(self._entries)
            self._append({"kind": "drop_model", "model": model})

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def close(self):
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    @classmethod
    def from_config(cls, cfg: Optional[CacheConfig]
                    ) -> Optional["InvocationCache"]:
        if cfg is None:
            return None
        return cls(cfg.index_path, fsync=cfg.fsync)
