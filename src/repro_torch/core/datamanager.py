"""DataManager (paper §4.6): token placement registry + transfer router.

R3 — with no shared data space, any inter-model transfer is always
*possible* via the two-step copy through the management node; intra-model
transfers use the connector's own channel (one hop; zero-copy when the
model exposes a shared store, the Occam /scratch analogue).

R4 — transfers are elided when the token is already present at the target;
a cheap local *staging* copy is still made (the paper does the same so
in-place modifications can't corrupt inputs).

Beyond-paper (flagged): with a ``TopologyGraph`` attached, a transfer is
*routed* — every live replica of the token is a candidate source, every
(source -> destination) route is scored against the declared link graph
(direct site-to-site hop, sibling-LAN hop, management push, or the R3
two-step fallback), and the cheapest executes.  ``routing: management``
in the topology block (or no topology at all) keeps every inter-model
move on the paper's two-step path — the measured control.

Beyond-paper (flagged): the data plane is *async-first* —
``transfer(ref, dst_model, dst_resource)`` returns a Future so token
movement for step N+1 overlaps compute of step N, with in-flight
transfers deduplicated per (token, destination): two consumers of one
token trigger one physical copy, the second rides the first's Future.
``transfer_sync`` runs the same single route implementation inline (the
serialized executor's path).  With ``content_routing`` on (cache-enabled
runs), the planner adds a zero-cost *digest* route: when the destination
store already holds the payload under any path, the transfer collapses
to an index alias and the journal records it as elided-by-digest.

Values enter and leave the plane as typed ``DataRef`` handles
(key + content digest + size + scatter tag) via ``put``/``get``; the old
``put_local``/``get_local`` spellings survive as deprecation shims.

Every movement is appended to ``transfers`` — the benchmark harness reads
this log to produce the paper's overhead accounting.  ``mgmt_bytes()``
reports how many bytes crossed the management node's own link, the number
direct routing exists to shrink.
"""
from __future__ import annotations

import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.core.connector import (Connector, ConnectorCopyKind, ObjectStore,
                                  deserialize, serialize)
from repro_torch.core.topology import (MANAGEMENT, Route, TopologyGraph,
                                 UnroutableError)
from repro_torch.core.workflow import parse_token_ref


@dataclass(frozen=True)
class DataRef:
    """Typed handle to one token's payload — the public currency of the
    data plane.  ``key`` is the token ref (``port[tag]``), ``digest`` the
    content address of the serialized payload, ``size`` its byte length
    and ``tag`` the scatter coordinate parsed from the key.  Everywhere a
    token string used to travel, a DataRef can travel instead and carries
    the content identity with it."""
    key: str
    digest: str
    size: int
    tag: Tuple[int, ...] = ()

    @property
    def port(self) -> str:
        return parse_token_ref(self.key)[0]

    def __str__(self) -> str:        # transfer APIs accept DataRef | str
        return self.key


def _token_key(ref: Union["DataRef", str]) -> str:
    return ref.key if isinstance(ref, DataRef) else ref


@dataclass
class TransferRecord:
    token: str
    kind: str    # elided | staging | intra-model | direct | two-step | collect
    src: Optional[str]
    dst: str
    bytes: int
    seconds: float
    route: str = ""          # planner's hop description, e.g. "hpc->cloud"
    # scatter identity of the token: the port it belongs to and its element
    # tag — filled from the ref, so per-port accounting (port_summary) can
    # group a whole scatter stream's movements
    port: str = ""
    tag: Tuple[int, ...] = ()

    def __post_init__(self):
        if not self.port:
            self.port, self.tag = parse_token_ref(self.token)


@dataclass
class _Location:
    model: str
    resource: str
    path: str


@dataclass
class RoutePlan:
    """One scored way of bringing a token to a destination."""
    kind: str                       # elided|staging|digest|intra-model|
    #                                 direct|mgmt-push|two-step
    cost: float
    source: Optional[_Location] = None     # None for mgmt-push/elided
    route: Optional[Route] = None          # topology path, when planned
    digest: Optional[str] = None           # content address (digest route)

    def describe(self) -> str:
        return self.route.describe() if self.route is not None else self.kind


class DataManager:
    def __init__(self, deployment_manager, scheduler=None, *,
                 transfer_workers: int = 8, journal=None,
                 topology: Optional[TopologyGraph] = None,
                 key_prefix: str = "", content_routing: bool = False):
        self.deployment_manager = deployment_manager
        self.scheduler = scheduler
        self.journal = journal                     # ExecutionJournal | None
        self.topology = topology                   # TopologyGraph | None
        # content-addressed routing: when on (cache-enabled runs), the
        # planner may satisfy a transfer by digest — the destination store
        # already holds the payload under *some* path, so the route is a
        # zero-cost index alias.  Off by default: `cache: off` runs must
        # produce byte-identical transfer logs to the pre-CAS engine.
        self.content_routing = content_routing
        # remote store keys get this per-run prefix so concurrent runs on
        # shared (pooled) sites can't collide — or falsely R4-elide — on
        # identical token refs; the per-run management store stays raw
        self.key_prefix = key_prefix
        self.event_sink = None                     # EventSink while streaming
        self._lock = threading.RLock()
        self.remote_paths: Dict[str, List[_Location]] = {}
        self.local_store = ObjectStore("management")  # the management node
        self.transfers: List[TransferRecord] = []
        self._transfer_workers = transfer_workers
        self._xfer_pool: Optional[ThreadPoolExecutor] = None
        # (token, dst_model, dst_resource) -> Future of the copy in flight
        self._inflight: Dict[Tuple[str, str, str], Future] = {}
        self.dedup_hits = 0                        # consumers served by an
                                                   # already-in-flight copy
        # bumped by drop_model: fences in-flight transfers so a copy that
        # lands after its site died can't register a stale replica
        self._model_epoch: Dict[str, int] = {}

    def _rkey(self, token: str) -> str:
        """Remote-store key for a token (namespaced per run)."""
        return self.key_prefix + token

    # -- registry ---------------------------------------------------------------
    def add_remote_path_mapping(self, model: str, resource: str,
                                token: str, path: Optional[str] = None):
        with self._lock:
            locs = self.remote_paths.setdefault(token, [])
            loc = _Location(model, resource, path or self._rkey(token))
            if any(l.resource == resource and l.path == loc.path
                   for l in locs):
                return
            locs.append(loc)
        # journal outside the lock: token locations survive the driver
        # (element tokens carry their scatter tag, so a replayed journal
        # shows exactly which slice of a partial scatter is durable)
        if self.journal is not None:
            _port, tag = parse_token_ref(token)
            self.journal.token(token, model, resource, loc.path,
                               tag=list(tag) or None)

    def locations(self, token: str) -> List[Tuple[str, str]]:
        with self._lock:
            return [(l.resource, l.path) for l in
                    self.remote_paths.get(token, [])]

    def has_replica(self, token: str, model: str) -> bool:
        with self._lock:
            return any(l.model == model
                       for l in self.remote_paths.get(token, []))

    def drop_model(self, model: str):
        """A site died/undeployed: forget every token replica it held and
        fence any transfer still in flight toward it."""
        if self.journal is not None:
            self.journal.drop_model(model)
        with self._lock:
            self._model_epoch[model] = self._model_epoch.get(model, 0) + 1
            # purge the dedup map too: a consumer arriving after a redeploy
            # must trigger a fresh copy, not join a doomed pre-drop future
            for key in [k for k in self._inflight if k[1] == model]:
                self._inflight.pop(key, None)
            for token in list(self.remote_paths):
                self.remote_paths[token] = [
                    l for l in self.remote_paths[token] if l.model != model]

    def stage_off(self, model: str) -> List[str]:
        """Planned scale-down/preemption: pull every token whose *only*
        registered copy lives on ``model`` back to the management node
        (and inline it into the journal, checkpoint policy permitting)
        before the site is undeployed.  Tokens with another replica, or
        already collected, are skipped; tokens the dying site can no
        longer serve are left to journal recovery.  Returns the tokens
        actually staged."""
        with self._lock:
            victims = [t for t, locs in self.remote_paths.items()
                       if locs and all(l.model == model for l in locs)]
        staged = []
        for token in victims:
            if not self.local_store.exists(token):
                try:
                    self.collect_output(token)
                except KeyError:
                    continue
            self.journal_payload(token)
            staged.append(token)
        return staged

    def token_size(self, token: str) -> int:
        """Size probe for schedulers/planners — called every tick, so it
        must use the counter-neutral ``ObjectStore.size`` probe (a ``get``
        here would inflate the byte accounting the benchmarks gate on)."""
        with self._lock:
            locs = self.remote_paths.get(token, [])
        if not locs:
            return max(self.local_store.size(token), 0)
        loc = locs[0]
        conn = self.deployment_manager.get_connector(loc.model)
        if conn is None:
            return 0
        try:
            return max(conn.store(loc.resource).size(loc.path), 0)
        except KeyError:
            return 0

    # -- value plane (management-node helpers) ------------------------------------
    def put(self, key: str, value: Any) -> DataRef:
        """Serialize ``value`` into the management store under ``key`` and
        return its typed handle (key + content digest + size + tag)."""
        payload = serialize(value)
        digest = self.local_store.put(key, payload)
        _port, tag = parse_token_ref(key)
        return DataRef(key=key, digest=digest, size=len(payload), tag=tag)

    def get(self, ref: Union[DataRef, str]) -> Any:
        """Deserialize the payload a DataRef (or raw token key) names out
        of the management store."""
        return deserialize(self.local_store.get(_token_key(ref)))

    def put_local(self, token: str, value: Any):
        """Deprecated spelling of :meth:`put` (returns nothing)."""
        warnings.warn(
            "DataManager.put_local is deprecated; use put(), which "
            "returns a typed DataRef", DeprecationWarning, stacklevel=2)
        self.put(token, value)

    def get_local(self, token: str) -> Any:
        """Deprecated spelling of :meth:`get`."""
        warnings.warn(
            "DataManager.get_local is deprecated; use get(), which also "
            "accepts a DataRef", DeprecationWarning, stacklevel=2)
        return self.get(token)

    def token_digest(self, token: str) -> Optional[str]:
        """Content digest of a token's payload, from whichever store holds
        it (management first, then registered replicas).  Counter-neutral:
        digest lookups never move bytes."""
        token = _token_key(token)
        digest = self.local_store.digest_of(token)
        if digest is not None:
            return digest
        with self._lock:
            locs = list(self.remote_paths.get(token, []))
        for loc in locs:
            conn = self.deployment_manager.get_connector(loc.model)
            if conn is None:
                continue
            try:
                digest = conn.store(loc.resource).digest_of(loc.path)
            except KeyError:
                continue
            if digest is not None:
                return digest
        return None

    # -- the route planner (R3/R4 + topology routing) ---------------------------
    def _live_replicas(self, token: str) -> List[_Location]:
        """Registered replicas whose site still answers and whose store
        still holds the payload — the router never trusts the registry
        blindly (a site may have died between registration and now)."""
        with self._lock:
            locs = list(self.remote_paths.get(token, []))
        live = []
        for loc in locs:
            conn = self.deployment_manager.get_connector(loc.model)
            if conn is None or not conn.ping(loc.resource):
                continue
            try:
                if conn.store(loc.resource).exists(loc.path):
                    live.append(loc)
            except KeyError:
                continue
        return live

    def plan_route(self, token: str, dst_model: str, dst_resource: str,
                   *, dst_conn=None) -> RoutePlan:
        """Score every live (replica source -> destination) route and
        return the cheapest.  Routes the executor can take:

          elided / staging   R4: already at (or visible from) the target
          intra-model        sibling-LAN hop inside the destination model
          direct             declared topology link, site to site
          mgmt-push          the management node already holds the bytes
          two-step           R3 fallback: source -> management -> target

        Ties keep the paper's preference order (sibling replica, then
        management push, then two-step).  With no topology — or
        ``routing: management`` — no direct route is ever planned.
        """
        if dst_conn is None:
            dst_conn = self.deployment_manager.get_connector(dst_model)
        if dst_conn is None:
            raise RuntimeError(f"target model {dst_model} not deployed")
        dst_store = dst_conn.store(dst_resource)
        live = self._live_replicas(token)

        # R4: already present at the destination store?
        present = dst_store.exists(self._rkey(token)) or any(
            l.model == dst_model and l.resource == dst_resource
            for l in live)
        if present:
            return RoutePlan("elided", 0.0)
        if dst_conn.shared_data_space() and any(
                l.model == dst_model for l in live):
            return RoutePlan("staging", 0.0)
        if self.content_routing:
            # fleet-wide R4: the destination store holds the *payload*
            # under some other path (an earlier run's key, a duplicate
            # artifact) — the transfer is an index alias, zero bytes
            digest = self.token_digest(token)
            if digest is not None and dst_store.has_digest(digest):
                return RoutePlan("digest", 0.0, digest=digest)

        size = max(self.token_size(token), 1)
        topo = self.topology
        # cost-based scoring is the *direct* routing mode; with
        # routing="management" (or no topology) the scoring key is
        # rank-only, which reproduces the paper's source pick exactly:
        # sibling replica, then first registered replica, then the
        # management node only when no replica exists
        use_costs = topo is not None and topo.routing in ("direct", "strict")
        # (cost, preference-rank, insertion-order) -> plan; ranks keep the
        # paper's tie-break order under the free-link default topology
        scored: List[Tuple[Tuple[float, int, int], RoutePlan]] = []
        for i, loc in enumerate(live):
            if loc.model == dst_model:
                scored.append(((0.0, 0, i),
                               RoutePlan("intra-model", 0.0, loc)))
            elif use_costs:
                try:
                    route = topo.route(loc.model, dst_model, size)
                except UnroutableError:
                    continue     # strict: this replica's site can't reach dst
                kind = ("direct" if route.hops
                        and not route.via_management else "two-step")
                scored.append(((route.cost, 1, i),
                               RoutePlan(kind, route.cost, loc, route)))
            else:
                route = (topo.two_step_route(loc.model, dst_model, size)
                         if topo is not None else None)
                cost = route.cost if route is not None else 0.0
                scored.append(((0.0, 1, i),
                               RoutePlan("two-step", cost, loc, route)))
        if self.local_store.exists(token):
            if topo is not None:
                route = topo.route(MANAGEMENT, dst_model, size)
                cost = route.cost
            else:
                route, cost = None, 0.0
            # rank 2: the paper sources from the management node only when
            # no replica exists; in direct mode the planner may still pick
            # it on merit (one hop beats two)
            scored.append(((cost if use_costs else 0.0, 2, 0),
                           RoutePlan("mgmt-push", cost, None, route)))
        if not scored:
            if live and topo is not None and topo.routing == "strict":
                raise UnroutableError(
                    f"token {token!r} lives on "
                    f"{sorted({l.model for l in live})} but no declared "
                    f"direct link reaches {dst_model} (routing: strict)")
            raise KeyError(f"token {token!r} exists nowhere (or every "
                           f"replica's site is dead)")
        return min(scored, key=lambda kv: kv[0])[1]

    def estimate_cost(self, token: str, dst_model: str) -> float:
        """Planner cost of bringing ``token`` onto ``dst_model`` — what the
        cost-weighted scheduler policy and the executor's stage-in
        ordering consume.  Without a topology the token's byte size is the
        proxy (more bytes == more worth prepaying)."""
        if self.has_replica(token, dst_model):
            return 0.0
        size = max(self.token_size(token), 1)
        if self.topology is None \
                or self.topology.routing not in ("direct", "strict"):
            return float(size)
        with self._lock:
            sources = {l.model for l in self.remote_paths.get(token, [])}
        costs = [self.topology.cost(s, dst_model, size) for s in sources]
        if self.local_store.exists(token):
            costs.append(self.topology.cost(MANAGEMENT, dst_model, size))
        return min(costs) if costs else 0.0

    def transfer_sync(self, ref: Union[DataRef, str], dst_model: str,
                      dst_resource: str) -> TransferRecord:
        """Ensure a token is present at (dst_model, dst_resource), over the
        cheapest planned route, synchronously in the calling thread.  This
        is the single implementation both entry points share; prefer the
        async-first :meth:`transfer` on hot paths (it adds in-flight
        deduplication per destination)."""
        token = _token_key(ref)
        t0 = time.time()
        dst_conn = self.deployment_manager.get_connector(dst_model)
        if dst_conn is None:
            raise RuntimeError(f"target model {dst_model} not deployed")
        dst_store = dst_conn.store(dst_resource)
        with self._lock:
            epoch = self._model_epoch.get(dst_model, 0)
        plan = self.plan_route(token, dst_model, dst_resource,
                               dst_conn=dst_conn)
        dst_tag = f"{dst_model}:{dst_resource}"

        if plan.kind in ("elided", "staging"):
            # staging copy only (negligible vs a remote transfer — paper §4.6)
            size = max(dst_store.size(self._rkey(token)), 0)
            rec = TransferRecord(token, plan.kind, None, dst_tag, size,
                                 time.time() - t0)
            # no-op transfers have nothing to replay: keep the (fsync'd)
            # journal records off the hottest transfer path
            self._done(rec, dst_model, dst_resource, token, epoch,
                       journaled=False)
            return rec

        if plan.kind == "digest":
            # zero-cost content route: alias this run's key onto the
            # payload the destination already holds — no bytes move
            dst_store.link_digest(self._rkey(token), plan.digest)
            rec = TransferRecord(token, "elided", None, dst_tag, 0,
                                 time.time() - t0, route="digest")
            if self.journal is not None:
                # replay treats unknown transfer states as inert, but the
                # journal still shows WHY no copy happened for this token
                self.journal.transfer(token, dst_model, dst_resource,
                                      "elided-by-digest", route="digest")
            self._done(rec, dst_model, dst_resource, token, epoch,
                       journaled=False)
            return rec

        if self.journal is not None:
            # write-ahead: a copy that was in flight when the driver died is
            # journaled as started-but-not-done; resume re-issues it and the
            # R4 elision / per-token dedup make the replay idempotent.  The
            # planned route rides along so a replayed journal shows *how*
            # the bytes moved, not just where they went.
            self.journal.transfer(token, dst_model, dst_resource, "start",
                                  route=plan.describe())

        src = plan.source
        src_conn = (self.deployment_manager.get_connector(src.model)
                    if src is not None else None)
        if src is not None and src_conn is None:
            # the source site died between planning and execution: re-plan
            # (liveness filtering drops its replicas on the next pass, so
            # this converges to another source or a clean KeyError)
            return self.transfer_sync(token, dst_model, dst_resource)
        if plan.kind == "mgmt-push":
            # one hop: the management node already holds the payload
            n = dst_conn.copy(token, self._rkey(token),
                              ConnectorCopyKind.LOCAL_TO_REMOTE,
                              local_store=self.local_store,
                              dest_remote=dst_resource)
            rec = TransferRecord(token, "two-step", "management", dst_tag,
                                 n, time.time() - t0, plan.describe())
        elif plan.kind == "intra-model":
            # the connector's own (optimised) channel — the sibling-LAN hop
            n = dst_conn.copy(src.path, self._rkey(token),
                              ConnectorCopyKind.REMOTE_TO_REMOTE,
                              source_remote=src.resource,
                              dest_remote=dst_resource)
            rec = TransferRecord(token, "intra-model",
                                 f"{src.model}:{src.resource}", dst_tag, n,
                                 time.time() - t0)
        elif plan.kind == "direct":
            # topology-routed: site to site over the declared link, never
            # touching the management node
            n = src_conn.copy(src.path, self._rkey(token),
                              ConnectorCopyKind.REMOTE_TO_REMOTE,
                              source_remote=src.resource,
                              dest_remote=dst_resource, peer=dst_conn,
                              link=plan.route.hops[0])
            rec = TransferRecord(token, "direct",
                                 f"{src.model}:{src.resource}", dst_tag, n,
                                 time.time() - t0, plan.describe())
        else:
            # R3 baseline: two copies through the management node
            n1 = src_conn.copy(src.path, token,
                               ConnectorCopyKind.REMOTE_TO_LOCAL,
                               source_remote=src.resource,
                               local_store=self.local_store)
            n2 = dst_conn.copy(token, self._rkey(token),
                               ConnectorCopyKind.LOCAL_TO_REMOTE,
                               local_store=self.local_store,
                               dest_remote=dst_resource)
            rec = TransferRecord(token, "two-step",
                                 f"{src.model}:{src.resource}", dst_tag,
                                 n1 + n2, time.time() - t0, plan.describe())
        self._done(rec, dst_model, dst_resource, token, epoch)
        return rec

    def _done(self, rec: TransferRecord, model: str, resource: str,
              token: str, epoch: int, journaled: bool = True):
        with self._lock:
            self.transfers.append(rec)
            stale = epoch != self._model_epoch.get(model, 0)
        sink = self.event_sink
        if sink is not None:
            from repro_torch.core.events import TransferRouted
            sink.emit(TransferRouted(token=rec.token, kind=rec.kind,
                                     route=rec.route, src=rec.src,
                                     dst=rec.dst, bytes=rec.bytes,
                                     seconds=rec.seconds))
        if stale:
            return              # site dropped mid-flight: don't register a
                                # replica the redeployed store doesn't hold
        self.add_remote_path_mapping(model, resource, token)
        if journaled and self.journal is not None:
            self.journal.transfer(token, model, resource, "done")

    def journal_payload(self, token: str):
        """Inline a token's bytes into the journal (checkpoint policy
        permitting), so recovery survives even total site loss."""
        if self.journal is None or not self.journal.include_payloads:
            return
        raw: Optional[bytes] = None
        if self.local_store.exists(token):
            raw = self.local_store.get(token)
        else:
            with self._lock:
                locs = list(self.remote_paths.get(token, []))
            for loc in locs:
                conn = self.deployment_manager.get_connector(loc.model)
                if conn is None:
                    continue
                try:
                    st = conn.store(loc.resource)
                    if st.exists(loc.path):
                        raw = st.get(loc.path)
                        break
                except KeyError:
                    continue
        if raw is not None:
            self.journal.payload(token, raw)

    # -- async transfer plane (pipelined executor) -------------------------------
    def _pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._xfer_pool is None:
                self._xfer_pool = ThreadPoolExecutor(
                    max_workers=self._transfer_workers,
                    thread_name_prefix="sf-xfer")
            return self._xfer_pool

    def transfer(self, ref: Union[DataRef, str], dst_model: str,
                 dst_resource: str) -> Future:
        """Issue (or join) an asynchronous transfer of a token to the
        destination — the async-first entry point of the data plane.  One
        physical copy per (token, destination) is in flight at a time:
        concurrent consumers share the same Future.  ``transfer_sync`` is
        the inline wrapper around the same route execution."""
        token = _token_key(ref)
        key = (token, dst_model, dst_resource)
        with self._lock:
            fut = self._inflight.get(key)
            if fut is not None:
                self.dedup_hits += 1
                return fut
            fut = self._pool().submit(self.transfer_sync, token,
                                      dst_model, dst_resource)
            self._inflight[key] = fut

        def _clear(f, key=key):
            with self._lock:
                # drop_model may have purged the key and a newer transfer
                # installed its own future — only evict our own entry
                if self._inflight.get(key) is f:
                    del self._inflight[key]
        fut.add_done_callback(_clear)
        return fut

    # deprecated spellings, kept callable so pre-DataRef code keeps
    # working: both near-duplicates now share ONE route implementation
    def transfer_data(self, token: Union[DataRef, str], dst_model: str,
                      dst_resource: str) -> TransferRecord:
        """Deprecated spelling of :meth:`transfer_sync`."""
        return self.transfer_sync(token, dst_model, dst_resource)

    def transfer_data_async(self, token: Union[DataRef, str],
                            dst_model: str, dst_resource: str) -> Future:
        """Deprecated spelling of :meth:`transfer`."""
        return self.transfer(token, dst_model, dst_resource)

    def prefetch(self, tokens, dst_model: str, dst_resource: str
                 ) -> List[Future]:
        """Start moving every token toward a freshly-scheduled step's
        resource; returns the futures the worker must await before it runs."""
        return [self.transfer(t, dst_model, dst_resource)
                for t in tokens]

    def close(self):
        """Drain the transfer pool (end-of-run cleanup)."""
        with self._lock:
            pool, self._xfer_pool = self._xfer_pool, None
            self._inflight.clear()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    # -- output retrieval --------------------------------------------------------
    def collect_output(self, token: str) -> Any:
        """Bring a token back to the management node (always called before a
        remote site is undeployed, and for local steps needing remote data).

        Replica- and liveness-aware: every registered replica is a
        candidate (cheapest management link first, when a topology is
        attached); replicas whose model is undeployed, whose site fails
        the health check, or whose store lost the payload are skipped.
        If *every* replica is dead, the journaled payload (checkpoint
        ``include_payloads``) is the last resort."""
        if self.local_store.exists(token):
            return deserialize(self.local_store.get(token))
        with self._lock:
            locs = list(self.remote_paths.get(token, []))
        if (self.topology is not None and self.topology.routing == "direct"
                and len(locs) > 1):
            size = max(self.token_size(token), 1)
            locs.sort(key=lambda l: self.topology.cost(
                l.model, MANAGEMENT, size))
        for src in locs:
            conn = self.deployment_manager.get_connector(src.model)
            if conn is None or not conn.ping(src.resource):
                continue
            t0 = time.time()
            try:
                if not conn.store(src.resource).exists(src.path):
                    continue
                n = conn.copy(src.path, token,
                              ConnectorCopyKind.REMOTE_TO_LOCAL,
                              source_remote=src.resource,
                              local_store=self.local_store)
            except KeyError:
                continue            # resource vanished under us: next replica
            with self._lock:
                self.transfers.append(TransferRecord(
                    token, "collect", f"{src.model}:{src.resource}",
                    "management", n, time.time() - t0))
            return deserialize(self.local_store.get(token))
        raw = self._journaled_payload(token)
        if raw is not None:
            self.local_store.put(token, raw)
            with self._lock:
                self.transfers.append(TransferRecord(
                    token, "collect", "journal", "management", len(raw), 0.0))
            return deserialize(raw)
        if locs:
            raise KeyError(f"token {token!r}: every replica's site is dead "
                           f"and no journaled payload exists")
        raise KeyError(f"token {token!r} not found anywhere")

    def _journaled_payload(self, token: str) -> Optional[bytes]:
        """Read a token's inline payload back out of the execution journal
        (only present when the checkpoint policy journals payloads)."""
        if self.journal is None:
            return None
        try:
            state = type(self.journal).replay(self.journal.path)
        except Exception:
            return None
        return state.payloads.get(token)

    # -- accounting ---------------------------------------------------------------
    def transfer_summary(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for r in self.transfers:
                d = out.setdefault(r.kind, {"n": 0, "bytes": 0, "seconds": 0.0})
                d["n"] += 1
                d["bytes"] += r.bytes
                d["seconds"] += r.seconds
        return out

    def port_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-port aggregation of the transfer log: a scatter stream's
        element movements (``shard[0]``, ``shard[1]``, ...) group under
        their port, with the distinct element count alongside —
        ``bench_scatter`` reads it to show that a stream's bytes stay one
        accountable port where hand-unrolling smears them over N token
        names."""
        out: Dict[str, Dict[str, float]] = {}
        tags: Dict[str, set] = {}
        with self._lock:
            for r in self.transfers:
                d = out.setdefault(r.port, {"n": 0, "bytes": 0,
                                            "seconds": 0.0, "elements": 0})
                d["n"] += 1
                d["bytes"] += r.bytes
                d["seconds"] += r.seconds
                tags.setdefault(r.port, set()).add(r.tag)
        for port, seen in tags.items():
            out[port]["elements"] = len(seen)
        return out

    def mgmt_bytes(self) -> int:
        """Bytes that crossed the management node's own link — what direct
        routing exists to shrink (workflow inputs/outputs still pass
        through it; relayed transfer traffic should not have to)."""
        return self.local_store.bytes_in + self.local_store.bytes_out
