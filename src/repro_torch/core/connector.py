"""The Connector interface (paper Fig. 2), re-grounded for accelerator sites.

The paper's connectors shell out to container orchestrators; ours manage
device-mesh *sites*.  The contract is kept method-for-method:

  deploy() / undeploy()                — model (site) lifecycle, called only
                                         by the DeploymentManager (R1)
  get_available_resources(service)     — replicas of a service in this model
  run(resource, command, ...)          — execute a step invocation
  copy(src, dst, kind, source_remote)  — move tokens between the management
                                         node and resources (R3)

Each resource owns an object store (the container filesystem analogue).
``copy`` moves *serialized* payloads so a two-step inter-site transfer has
real, measurable cost (bytes appear in the DataManager transfer log).
"""
from __future__ import annotations

import abc
import enum
import hashlib
import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class ConnectorCopyKind(enum.Enum):
    LOCAL_TO_REMOTE = "localToRemote"
    REMOTE_TO_LOCAL = "remoteToLocal"
    REMOTE_TO_REMOTE = "remoteToRemote"


@dataclass
class ResourceInfo:
    name: str
    service: str
    cores: int = 1
    memory_gb: float = 4.0


def content_digest(payload: bytes) -> str:
    """Canonical content digest of a serialized payload (sha256 hex).

    This is the identity the whole data plane keys on: CAS dedup inside a
    store, the planner's "already-present" elision across stores, and the
    invocation memo key all hash the same way."""
    return hashlib.sha256(payload).hexdigest()


class ObjectStore:
    """Per-resource content-addressed payload store with byte accounting.

    Paths (token keys) index into a digest-keyed CAS: each distinct payload
    is held once, however many paths reference it, so duplicate puts on a
    site cost no extra memory and ``size``/``exists``/``digest_of`` answer
    from the path→digest index alone.  ``name`` identifies the owning
    resource (or site, for shared stores) so a missed lookup names where
    the token was expected, not just its key.

    Byte accounting is deliberately *logical*: ``bytes_in``/``bytes_out``
    count what callers pushed/pulled (every put and get, dedup or not) so
    transfer metrics are invariant to the CAS internals; the dedup win is
    visible separately via ``dedup_puts``/``dedup_bytes``/``unique_bytes``.
    Metadata probes (``exists``/``size``/``digest_of``/``has_digest``/
    ``link_digest``) never touch the byte counters."""

    def __init__(self, name: str = "store"):
        self.name = name
        self._cas: Dict[str, bytes] = {}      # digest -> payload (once)
        self._index: Dict[str, str] = {}      # path -> digest
        self._refs: Dict[str, int] = {}       # digest -> live path count
        self._lock = threading.Lock()
        self.bytes_in = 0
        self.bytes_out = 0
        self.dedup_puts = 0     # puts whose payload was already held
        self.dedup_bytes = 0    # bytes those puts did NOT duplicate

    # -- internal (lock held) -------------------------------------------------
    def _bind(self, path: str, digest: str):
        old = self._index.get(path)
        if old == digest:
            return
        self._index[path] = digest
        self._refs[digest] = self._refs.get(digest, 0) + 1
        if old is not None:
            self._release(old)

    def _release(self, digest: str):
        n = self._refs.get(digest, 0) - 1
        if n <= 0:
            self._refs.pop(digest, None)
            self._cas.pop(digest, None)
        else:
            self._refs[digest] = n

    # -- data plane -----------------------------------------------------------
    def put(self, path: str, payload: bytes) -> str:
        """Store a payload under ``path``; returns its content digest.
        A duplicate put (payload already in the CAS) only adds an index
        entry — the bytes are not held twice."""
        digest = content_digest(payload)
        with self._lock:
            if digest in self._cas:
                self.dedup_puts += 1
                self.dedup_bytes += len(payload)
            else:
                self._cas[digest] = payload
            self._bind(path, digest)
            self.bytes_in += len(payload)
        return digest

    def get(self, path: str) -> bytes:
        with self._lock:
            digest = self._index.get(path)
            payload = self._cas.get(digest) if digest is not None else None
            if payload is None:
                raise KeyError(
                    f"object store {self.name!r} holds no payload at "
                    f"{path!r} — the token was never transferred here, or "
                    f"the site was redeployed and lost it")
            self.bytes_out += len(payload)
            return payload

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._index

    def size(self, path: str) -> int:
        """Byte length of a stored payload, or -1 when absent.  A metadata
        probe: does NOT touch the bytes_in/bytes_out accounting, so
        planners may ask freely without polluting transfer metrics."""
        with self._lock:
            digest = self._index.get(path)
            if digest is None:
                return -1
            return len(self._cas[digest])

    def delete(self, path: str):
        """Drop a path; the payload survives while other paths share its
        digest and is freed with the last reference."""
        with self._lock:
            digest = self._index.pop(path, None)
            if digest is not None:
                self._release(digest)

    def paths(self) -> List[str]:
        with self._lock:
            return list(self._index)

    # -- content addressing (all metadata probes: counter-neutral) ------------
    def digest_of(self, path: str) -> Optional[str]:
        """Content digest stored at ``path``, or None when absent."""
        with self._lock:
            return self._index.get(path)

    def has_digest(self, digest: str) -> bool:
        """True if any live path in this store holds the payload."""
        with self._lock:
            return digest in self._cas

    def link_digest(self, path: str, digest: str) -> bool:
        """Alias ``path`` to a payload already in the CAS — the zero-cost
        'already-present' route.  Returns False (and changes nothing) when
        the digest is not held here; no bytes move either way."""
        with self._lock:
            if digest not in self._cas:
                return False
            self._bind(path, digest)
            return True

    def unique_bytes(self) -> int:
        """Bytes physically held (one copy per digest)."""
        with self._lock:
            return sum(len(p) for p in self._cas.values())


def serialize(value: Any) -> bytes:
    return pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)


def deserialize(payload: bytes) -> Any:
    return pickle.loads(payload)


class Connector(abc.ABC):
    """One *model* (deployment unit).  Subclasses define the site semantics.

    Mirrors the paper's design: a new Connector façade can be handed out per
    caller (``clone``) while the underlying site state is shared — avoiding
    cross-thread conflicts without fully-atomic method access.
    """

    def __init__(self, name: str, config: Optional[dict] = None):
        self.name = name
        self.config = config or {}
        self.deployed = False
        self._alive = True

    # -- lifecycle (R1: atomic unit; only DeploymentManager calls these) ----
    @abc.abstractmethod
    def deploy(self) -> None:
        ...

    @abc.abstractmethod
    def undeploy(self) -> None:
        ...

    # -- discovery -----------------------------------------------------------
    @abc.abstractmethod
    def get_available_resources(self, service: str) -> List[str]:
        ...

    @abc.abstractmethod
    def resource_info(self, resource: str) -> ResourceInfo:
        ...

    # -- execution ------------------------------------------------------------
    @abc.abstractmethod
    def run(self, resource: str, command: Any,
            environment: Optional[Dict[str, str]] = None,
            workdir: Optional[str] = None,
            capture_output: bool = False) -> Any:
        ...

    # -- data plane -----------------------------------------------------------
    @abc.abstractmethod
    def store(self, resource: str) -> ObjectStore:
        ...

    def copy(self, src: str, dst: str, kind: ConnectorCopyKind,
             source_remote: Optional[str] = None, *,
             local_store: Optional[ObjectStore] = None,
             dest_remote: Optional[str] = None,
             peer: Optional["Connector"] = None,
             link=None) -> int:
        """Move one payload; returns bytes moved.

        src/dst are store paths (token keys).  ``source_remote`` /
        ``dest_remote`` name resources for the remote ends;
        ``local_store`` is the management node's store.

        Config may declare a simulated WAN link between this site and the
        management node (``link_latency_s`` per copy + ``link_bandwidth_mbps``)
        so cross-site hops have real, measurable cost — this is what the
        pipelined executor overlaps with compute.

        ``REMOTE_TO_REMOTE`` with a ``peer`` connector is the *direct*
        cross-model channel (topology-routed transfers): the payload moves
        from this site's store straight into the peer site's store, paying
        the declared ``link`` cost (a ``topology.LinkSpec``) and never
        touching the management node.  Without a peer it is the classic
        intra-model hop.
        """
        if kind is ConnectorCopyKind.LOCAL_TO_REMOTE:
            payload = local_store.get(src)
            self._link_delay(len(payload))
            self.store(dest_remote).put(dst, payload)
        elif kind is ConnectorCopyKind.REMOTE_TO_LOCAL:
            payload = self.store(source_remote).get(src)
            self._link_delay(len(payload))
            local_store.put(dst, payload)
        elif peer is not None and peer.name != self.name:
            # direct site-to-site hop over a declared topology link
            payload = self.store(source_remote).get(src)
            if link is not None:
                delay = link.cost(len(payload))
                if delay > 0:
                    time.sleep(delay)
            peer.store(dest_remote).put(dst, payload)
        else:  # REMOTE_TO_REMOTE within this model
            payload = self.store(source_remote).get(src)
            self.store(dest_remote).put(dst, payload)
        return len(payload)

    def _link_delay(self, n_bytes: int):
        """Sleep out the declared management-node link cost (0 by default)."""
        latency = float(self.config.get("link_latency_s", 0.0))
        mbps = float(self.config.get("link_bandwidth_mbps", 0.0))
        delay = latency + (n_bytes * 8 / (mbps * 1e6) if mbps > 0 else 0.0)
        if delay > 0:
            time.sleep(delay)

    def services(self) -> List[str]:
        """Service names this model exposes (wrappers may delegate)."""
        return list(self.config.get("services", {"default": {}}).keys())

    # -- hybrid-data-space hints (R3/R4 optimisations) ------------------------
    def shared_data_space(self) -> bool:
        """True if all resources in this model see one store (e.g. the
        paper's Occam /scratch LUSTRE mount)."""
        return False

    # -- health (fault-tolerance hooks) ---------------------------------------
    def ping(self, resource: Optional[str] = None) -> bool:
        return self._alive and self.deployed

    def clone(self) -> "Connector":
        """Per-caller façade sharing the underlying site state (paper §4.5)."""
        import copy as _copy
        twin = _copy.copy(self)
        return twin
