"""Autoscaler: elastic replica control over the deployment plane.

Closes the loop between the scheduler's live queue state and the
deployment pool.  A per-model policy (``autoscale:`` block) gives the
replica envelope (``min``/``max``), the pressure targets
(``target_queue_depth`` per live replica, optional ``target_utilization``
over the model group's resources) and a ``cooldown_s`` damping scale
decisions.  Replica sites are full models named ``base~N``
(:data:`~repro_torch.core.deployment.REPLICA_SEP`): they register with the
DeploymentPlane from a deep copy of the base's spec, inherit the base's
topology links (so the PR-4 cost model places onto them exactly like the
base), and hold a lease so the pool's idle keep-alive never evicts a
replica the autoscaler still wants.

Scale-down is *planned*, not a crash: the replica is drained (scheduler
drain flag + deployment drain flag, journaled as a ``drain`` deployment
event), running work is left to finish, live outputs whose only copy
sits on the victim are staged off through the DataManager, and only then
is the site undeployed.  A ``preemptible: true`` model gets spot
semantics instead: revocation is immediate (journaled ``preempt``), any
invocation mid-step on the victim falls through to the existing journal
recovery path — the executor's fault handler sees the drain flag and
retries elsewhere instead of resurrecting the revoked site.

The whole subsystem is additive: no ``autoscale:`` block means no
Autoscaler object, no queue reporting, and byte-identical behaviour to
the static pool.
"""
from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.core.deployment import (DeploymentPlane, ModelSpec, REPLICA_SEP,
                                   replica_base)

_POLICY_KEYS = {"min", "max", "target_queue_depth", "target_utilization",
                "preemptible"}
_CONFIG_KEYS = {"enabled", "cooldown_s", "interval_s", "max_total_replicas",
                "models"}


@dataclass(frozen=True)
class AutoscalePolicy:
    """Per-model replica envelope + pressure targets."""
    min: int = 1
    max: int = 1
    target_queue_depth: float = 2.0
    target_utilization: Optional[float] = None
    preemptible: bool = False

    @classmethod
    def from_dict(cls, model: str, doc: dict) -> "AutoscalePolicy":
        unknown = set(doc) - _POLICY_KEYS
        if unknown:
            raise ValueError(f"autoscale.models.{model}: unknown key(s) "
                             f"{sorted(unknown)}")
        pol = cls(min=int(doc.get("min", 1)), max=int(doc.get("max", 1)),
                  target_queue_depth=float(doc.get("target_queue_depth", 2)),
                  target_utilization=(
                      None if doc.get("target_utilization") is None
                      else float(doc["target_utilization"])),
                  preemptible=bool(doc.get("preemptible", False)))
        if pol.min < 0 or pol.max < 1:
            raise ValueError(f"autoscale.models.{model}: min must be >= 0 "
                             f"and max >= 1")
        if pol.min > pol.max:
            raise ValueError(f"autoscale.models.{model}: min ({pol.min}) "
                             f"exceeds max ({pol.max})")
        return pol


@dataclass(frozen=True)
class AutoscaleConfig:
    """Parsed ``autoscale:`` block."""
    enabled: bool = True
    cooldown_s: float = 0.0
    interval_s: float = 0.05
    max_total_replicas: Optional[int] = None
    models: Dict[str, AutoscalePolicy] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, doc: Optional[dict]) -> Optional["AutoscaleConfig"]:
        """Parse the block; ``None`` / ``{}`` / ``enabled: false`` all
        mean *no autoscaler* — the off-switch is the block's absence."""
        if not doc:
            return None
        unknown = set(doc) - _CONFIG_KEYS
        if unknown:
            raise ValueError(f"autoscale: unknown key(s) {sorted(unknown)}")
        if not doc.get("enabled", True):
            return None
        models = {name: AutoscalePolicy.from_dict(name, pol or {})
                  for name, pol in (doc.get("models") or {}).items()}
        mtr = doc.get("max_total_replicas")
        return cls(enabled=True,
                   cooldown_s=float(doc.get("cooldown_s", 0.0)),
                   interval_s=float(doc.get("interval_s", 0.05)),
                   max_total_replicas=None if mtr is None else int(mtr),
                   models=models)


@dataclass(frozen=True)
class ScaleEnvelope:
    """Static upper bound on concurrently-live sites — what the plan-time
    analyzer charges a scatter group against.  ``per_model`` maps a base
    model to its maximum live sites (base + extras, ``>= 1``);
    ``max_total_extras`` is the global ``max_total_replicas`` cap on
    extra replicas across every model (None = uncapped)."""
    per_model: Dict[str, int]
    max_total_extras: Optional[int]

    def max_sites(self, models) -> int:
        """Most sites the named model group can ever have live at once:
        one base each, plus per-model extra headroom, jointly capped by
        ``max_total_replicas`` (extras are a shared budget, so the bound
        assumes the whole budget could serve this group)."""
        names = list(dict.fromkeys(models))
        extras = sum(self.per_model.get(m, 1) - 1 for m in names)
        if self.max_total_extras is not None:
            extras = min(extras, self.max_total_extras)
        return len(names) + extras


def scale_envelope(block: Any, models: Optional[Dict[str, Any]] = None
                   ) -> ScaleEnvelope:
    """Export the ``autoscale:`` block's replica envelope without building
    an Autoscaler.  An absent/disabled block yields the static-pool
    envelope (every model pinned at 1 site, zero extras); an external
    (user-managed) model never scales regardless of its declared ``max``
    — ``scale_up`` refuses to clone capacity the engine does not own."""
    cfg = AutoscaleConfig.from_dict(block if isinstance(block, dict)
                                    else None)
    if cfg is None:
        return ScaleEnvelope(per_model={}, max_total_extras=0)
    per: Dict[str, int] = {}
    for name, pol in cfg.models.items():
        spec = (models or {}).get(name)
        external = bool(getattr(spec, "external", False))
        per[name] = 1 if external else max(pol.max, 1)
    return ScaleEnvelope(per_model=per,
                         max_total_extras=cfg.max_total_replicas)


class Autoscaler:
    """Drives replica counts from scheduler snapshots.

    ``tick()`` is the whole control loop: take a
    :class:`~repro_torch.core.scheduler.SchedulerSnapshot`, finalize any drain
    whose site has gone quiet, then per managed model compare queue
    depth / utilization against the policy and scale by at most one
    replica per tick (cooldown-damped).  The executor calls it from its
    scheduling loop; the service runs it on a background thread.
    """

    def __init__(self, config: AutoscaleConfig, deployment: DeploymentPlane,
                 scheduler, *, data=None, topology=None, journal=None):
        self.config = config
        self.deployment = deployment
        self.scheduler = scheduler
        self.topology = topology
        self.journal = journal
        self._lock = threading.RLock()
        # every DataManager whose tokens might live on a replica we own
        # (one in executor mode; one per active run in service mode)
        self._data_planes: List[Any] = [data] if data is not None else []
        self._replicas: Dict[str, List[str]] = {}   # lock: _lock; base -> live extras
        self._ordinal: Dict[str, int] = {}          # lock: _lock; base -> next suffix
        self._draining: Dict[str, bool] = {}        # lock: _lock; site -> preempted?
        self._last_action: Dict[str, float] = {}    # lock: _lock; base -> monotonic t
        # stats (benchmarks + tests read these)
        self.scale_up_events = 0
        self.scale_down_events = 0
        self.preempt_events = 0

    # -- data-plane registry (service mode attaches one per run) ---------------
    def attach_data(self, data) -> None:
        with self._lock:
            if data not in self._data_planes:
                self._data_planes.append(data)

    def detach_data(self, data) -> None:
        with self._lock:
            if data in self._data_planes:
                self._data_planes.remove(data)

    # -- introspection ----------------------------------------------------------
    def replicas(self, base: str) -> List[str]:
        with self._lock:
            return list(self._replicas.get(base, []))

    def live_count(self, base: str) -> int:
        """Schedulable sites of a model: the base plus non-draining extras."""
        with self._lock:
            extras = [r for r in self._replicas.get(base, [])
                      if r not in self._draining]
            return 1 + len(extras)

    def total_extra_replicas(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._replicas.values())

    # -- control loop -----------------------------------------------------------
    def tick(self, snapshot=None):
        """One control iteration; returns the snapshot it acted on."""
        snap = (self.scheduler.export_state(running_only=True)
                if snapshot is None else snapshot)
        self._finalize_quiet_drains(snap)
        for base, pol in self.config.models.items():
            self._scale_model(base, pol, snap)
        return snap

    def _cooldown_ok(self, base: str) -> bool:
        with self._lock:
            last = self._last_action.get(base)
        return last is None or \
            time.monotonic() - last >= self.config.cooldown_s

    def _scale_model(self, base, pol: AutoscalePolicy, snap):
        live = self.live_count(base)
        floor = max(pol.min, 1)
        if live < floor:
            # below the floor: cooldown never blocks reaching min
            while live < floor and self.scale_up(base) is not None:
                live += 1
            return
        if not self._cooldown_ok(base):
            return
        group = [base, *self.replicas(base)]
        depth = snap.queue_depth.get(base, 0)
        running = sum(snap.running.get(s, 0) for s in group)
        capacity = sum(1 for r in snap.resources.values()
                       if replica_base(r["model"]) == base)
        hot = depth > pol.target_queue_depth * live
        if not hot and pol.target_utilization is not None and capacity:
            hot = depth > 0 and running / capacity > pol.target_utilization
        if hot and live < pol.max:
            self.scale_up(base)
        elif depth == 0 and live > floor:
            victim = self._idle_victim(base, snap)
            if victim is not None:
                self.scale_down(victim, preempt=pol.preemptible)

    def _idle_victim(self, base: str, snap) -> Optional[str]:
        """Newest non-draining replica with nothing running on it."""
        with self._lock:
            extras = [r for r in self._replicas.get(base, [])
                      if r not in self._draining]
        for rep in reversed(extras):
            if snap.running.get(rep, 0) == 0:
                return rep
        return None

    # -- scale-up ----------------------------------------------------------------
    def scale_up(self, base: str) -> Optional[str]:
        """Deploy one extra replica of ``base``; returns its site name,
        or None if the spec is unknown/external or a cap binds."""
        spec = self.deployment.spec_of(base)
        if spec is None or spec.external:
            return None            # external sites are user-managed capacity
        cap = self.config.max_total_replicas
        with self._lock:
            if cap is not None and self.total_extra_replicas() >= cap:
                return None
            n = self._ordinal.get(base, 0) + 1
            self._ordinal[base] = n
            name = f"{base}{REPLICA_SEP}{n}"
        clone = ModelSpec(name=name, type=spec.type,
                          config=copy.deepcopy(spec.config), external=False)
        self.deployment.register(clone)
        if self.topology is not None:
            self.topology.clone_site(base, name)
        # lease (deploy + pin): replicas never fall to idle keep-alive —
        # only an explicit scale-down or preemption removes them
        conn = self.deployment.lease(name)
        for service in conn.services():
            for res in conn.get_available_resources(service):
                info = conn.resource_info(res)
                self.scheduler.register_resource(
                    res, name, service, info.cores, info.memory_gb)
        with self._lock:
            self._replicas.setdefault(base, []).append(name)
            self._last_action[base] = time.monotonic()
            self.scale_up_events += 1
        return name

    # -- scale-down / preemption -------------------------------------------------
    def scale_down(self, site: str, *, preempt: bool = False) -> None:
        """Retire a replica site.  Graceful (default): drain — no new
        placements, running work finishes, then the site is finalized by
        a later tick.  ``preempt=True`` revokes immediately: mid-step
        work on the victim dies into the journal recovery path."""
        base = replica_base(site)
        with self._lock:
            if site == base or site not in self._replicas.get(base, []):
                raise KeyError(f"{site!r} is not an autoscaled replica")
            if site in self._draining:
                return
            self._draining[site] = preempt
        # order matters: flags first (placement stops), journal event is
        # written by the deployment plane's drain()
        self.scheduler.set_draining(site)
        self.deployment.drain(site, preempt=preempt)
        with self._lock:
            self._last_action[base] = time.monotonic()
            if preempt:
                self.preempt_events += 1
            else:
                self.scale_down_events += 1
        if preempt:
            self._finalize(site)

    def preempt(self, site: str) -> None:
        """External spot revocation of a replica (benchmark/ops hook)."""
        self.scale_down(site, preempt=True)

    def _finalize_quiet_drains(self, snap) -> None:
        with self._lock:
            quiet = [s for s, pre in self._draining.items() if not pre
                     and snap.running.get(s, 0) == 0]
        for site in quiet:
            if not self.scheduler.running_on(site):
                self._finalize(site)

    def _finalize(self, site: str) -> None:
        """Tear a drained replica down: stage off any token whose only
        copy lives there, then release the lease and undeploy."""
        base = replica_base(site)
        with self._lock:
            self._draining.pop(site, None)
            reps = self._replicas.get(base, [])
            if site in reps:
                reps.remove(site)
            planes = list(self._data_planes)
        for dm in planes:
            try:
                dm.stage_off(site)
            except Exception:
                # a preempted site may already be unreachable: journal
                # recovery re-runs whatever could not be staged
                pass
        self.deployment.release(site)
        self.deployment.undeploy(site)
        for dm in planes:
            dm.drop_model(site)
        self.scheduler.forget_model(site)
        # scheduler drain flag can go (resources are gone); the deployment
        # drain flag STAYS so the fault path never redeploys the site
        self.scheduler.set_draining(site, False)

    def shutdown(self) -> None:
        """End-of-run cleanup: gracefully finalize every live replica."""
        with self._lock:
            sites = [s for reps in self._replicas.values() for s in reps]
            pending = [s for s in self._draining]
        for site in pending:
            self._finalize(site)
        for site in sites:
            with self._lock:
                if site in self._draining:
                    continue
                self._draining[site] = False
            self.scheduler.set_draining(site)
            self.deployment.drain(site)
            self._finalize(site)
