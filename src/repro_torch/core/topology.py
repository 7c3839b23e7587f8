"""Data-space topology graph + transfer route planner (beyond-paper).

The paper's R3 rule makes the management node the *only* bridge between
models that share no data space: every inter-model movement is a two-step
copy (site -> management -> site), so the management node's link is a
bandwidth bottleneck and a makespan tax on hybrid runs.  Multi-cloud
execution layers (GA4GH TES, HPC-Kubernetes bridges) instead treat the
site graph as a first-class object and move data over the cheapest
declared link.

This module is that graph.  A StreamFlow file may declare a ``topology:``
block:

  topology:
    routing: direct          # or "management" — the paper's R3 behaviour
    management:              # default star-link cost (site <-> mgmt node)
      latency_s: 0.05
      bandwidth_mbps: 200
    links:                   # declared site-to-site links
      - source: occam
        target: garr_cloud
        latency_s: 0.01
        bandwidth_mbps: 1000
        symmetric: true      # default: also adds target -> source

Every model always has an edge to the implicit management node (the
paper's star): per-model ``link_latency_s`` / ``link_bandwidth_mbps``
config wins, else the ``management:`` defaults, else a free link.  The
DataManager scores every (replica source -> destination) route against
this graph — direct hop, sibling-LAN hop, or the two-step fallback — and
executes the cheapest; the same costs feed the scheduler's cost-weighted
locality policy and the executor's stage-in ordering.  With
``routing: management`` (or no topology at all) the planner only ever
answers the paper's two-step route, which stays available as the
measured control.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: Name of the implicit management-node vertex in every topology graph.
MANAGEMENT = "__management__"


class UnroutableError(RuntimeError):
    """Raised under ``routing: strict`` when two sites share no declared
    direct link: the management relay is not available as a fallback, so
    the transfer cannot be executed at all (the analyzer's SF303 proves
    this condition ahead of the run)."""


@dataclass(frozen=True)
class LinkSpec:
    """One directed inter-site link with a simulated cost model."""
    source: str
    target: str
    latency_s: float = 0.0
    bandwidth_mbps: float = 0.0        # 0 => infinite bandwidth

    def cost(self, n_bytes: int) -> float:
        """Seconds to move ``n_bytes`` over this link."""
        bw = (n_bytes * 8 / (self.bandwidth_mbps * 1e6)
              if self.bandwidth_mbps > 0 else 0.0)
        return self.latency_s + bw


@dataclass
class Route:
    """A planned path for one payload: an ordered list of links."""
    hops: List[LinkSpec]
    cost: float

    @property
    def via_management(self) -> bool:
        return any(MANAGEMENT in (h.source, h.target) for h in self.hops)

    def describe(self) -> str:
        if not self.hops:
            return "local"
        names = [self.hops[0].source] + [h.target for h in self.hops]
        return "->".join("mgmt" if n == MANAGEMENT else n for n in names)


class TopologyGraph:
    """Inter-site link graph with the management-node star as backbone.

    ``routing="direct"`` lets the planner use declared site-to-site links;
    ``routing="management"`` restricts every inter-model route to the
    paper's two-step copy (the R3 control), whatever links are declared.
    ``routing="strict"`` goes the other way: only declared direct links
    carry inter-site data — the management relay never backstops a missing
    link, and routing two sites with no declared link raises
    :class:`UnroutableError` (star edges still carry driver-owned data,
    which is how external inputs arrive in the first place).
    """

    #: route() memo entries kept before the cache resets (a wide scatter
    #: asks for the same few (source, target, size) routes thousands of
    #: times — once per element token per placement candidate)
    ROUTE_CACHE_MAX = 4096

    def __init__(self, routing: str = "direct"):
        if routing not in ("direct", "management", "strict"):
            raise ValueError(f"unknown routing mode {routing!r}; "
                             f"expected 'direct', 'management' or 'strict'")
        self.routing = routing
        # (source, target) -> LinkSpec; management star edges included
        self._links: Dict[Tuple[str, str], LinkSpec] = {}
        self._sites: List[str] = []
        # (source, target, n_bytes) -> Route; invalidated on graph edits
        self._route_cache: Dict[Tuple[str, str, int], Route] = {}

    # -- construction ---------------------------------------------------------
    def add_site(self, name: str, *, mgmt_latency_s: float = 0.0,
                 mgmt_bandwidth_mbps: float = 0.0):
        """Register a site and its (always-present) management star edge."""
        if name not in self._sites:
            self._sites.append(name)
        for a, b in ((name, MANAGEMENT), (MANAGEMENT, name)):
            self._links[(a, b)] = LinkSpec(a, b, mgmt_latency_s,
                                           mgmt_bandwidth_mbps)
        self._route_cache.clear()

    def add_link(self, source: str, target: str, *, latency_s: float = 0.0,
                 bandwidth_mbps: float = 0.0, symmetric: bool = True):
        if MANAGEMENT in (source, target):
            raise ValueError("management star edges come from add_site")
        for name in (source, target):
            if name not in self._sites:
                self.add_site(name)
        self._links[(source, target)] = LinkSpec(source, target, latency_s,
                                                 bandwidth_mbps)
        if symmetric:
            self._links[(target, source)] = LinkSpec(target, source,
                                                     latency_s,
                                                     bandwidth_mbps)
        self._route_cache.clear()

    def clone_site(self, base: str, name: str):
        """Register ``name`` with the same links as ``base``: autoscaled
        replica sites inherit the base's position in the cost model, so
        the locality policy and the transfer planner score a replica
        exactly like the site it clones."""
        up = self.mgmt_link(base, outbound=True)
        self.add_site(name, mgmt_latency_s=up.latency_s,
                      mgmt_bandwidth_mbps=up.bandwidth_mbps)
        for (a, b), l in list(self._links.items()):
            if a == base and b not in (MANAGEMENT, name):
                self._links[(name, b)] = LinkSpec(name, b, l.latency_s,
                                                  l.bandwidth_mbps)
            elif b == base and a not in (MANAGEMENT, name):
                self._links[(a, name)] = LinkSpec(a, name, l.latency_s,
                                                  l.bandwidth_mbps)
        self._route_cache.clear()

    @classmethod
    def from_config(cls, models: Dict[str, object],
                    doc: Optional[dict] = None) -> "TopologyGraph":
        """Build the graph for a set of ModelSpecs + a ``topology:`` block.

        Per-model ``link_latency_s`` / ``link_bandwidth_mbps`` (the WAN
        model the Connector already simulates on management copies) define
        that site's star edge; the block's ``management:`` entry supplies
        defaults for models that don't declare one.
        """
        doc = doc or {}
        g = cls(routing=doc.get("routing", "direct"))
        mgmt = doc.get("management", {})
        for name, spec in models.items():
            config = getattr(spec, "config", None)
            if config is None and isinstance(spec, dict):
                config = spec.get("config", {})
            config = config or {}
            g.add_site(
                name,
                mgmt_latency_s=float(config.get(
                    "link_latency_s", mgmt.get("latency_s", 0.0))),
                mgmt_bandwidth_mbps=float(config.get(
                    "link_bandwidth_mbps", mgmt.get("bandwidth_mbps", 0.0))))
        for link in doc.get("links", []):
            for end in ("source", "target"):
                if link[end] not in g._sites:
                    raise KeyError(f"topology link references unknown "
                                   f"model {link[end]!r}")
            g.add_link(link["source"], link["target"],
                       latency_s=float(link.get("latency_s", 0.0)),
                       bandwidth_mbps=float(link.get("bandwidth_mbps", 0.0)),
                       symmetric=bool(link.get("symmetric", True)))
        return g

    # -- queries --------------------------------------------------------------
    def sites(self) -> List[str]:
        return list(self._sites)

    def link(self, source: str, target: str) -> Optional[LinkSpec]:
        return self._links.get((source, target))

    def mgmt_link(self, site: str, *, outbound: bool = True) -> LinkSpec:
        """The star edge for ``site`` (free if the site was never added)."""
        key = (site, MANAGEMENT) if outbound else (MANAGEMENT, site)
        got = self._links.get(key)
        if got is not None:
            return got
        a, b = key
        return LinkSpec(a, b)

    def two_step_route(self, source: str, target: str, n_bytes: int
                       ) -> Route:
        """The paper's R3 path: source -> management -> target."""
        up = self.mgmt_link(source, outbound=True)
        down = self.mgmt_link(target, outbound=False)
        return Route([up, down], up.cost(n_bytes) + down.cost(n_bytes))

    def route(self, source: str, target: str, n_bytes: int) -> Route:
        """Cheapest planned route for ``n_bytes`` from site to site.

        Candidates are the shapes the DataManager can execute: the direct
        declared link (one hop) and the two-step management relay (always
        available).  Same-site movement is free — the sibling-LAN hop.
        With ``routing="management"`` only the relay is considered.

        Memoised on (source, target, n_bytes): a scatter's element tokens
        share a handful of sizes, so the planner's per-token, per-candidate
        queries collapse to dictionary hits.  Callers must treat the
        returned Route as immutable.
        """
        key = (source, target, n_bytes)
        hit = self._route_cache.get(key)
        if hit is not None:
            return hit
        if source == target:
            route = Route([], 0.0)
        elif source == MANAGEMENT:
            down = self.mgmt_link(target, outbound=False)
            route = Route([down], down.cost(n_bytes))
        elif target == MANAGEMENT:
            up = self.mgmt_link(source, outbound=True)
            route = Route([up], up.cost(n_bytes))
        elif self.routing == "strict":
            direct = self._links.get((source, target))
            if direct is None:
                raise UnroutableError(
                    f"no direct link {source} -> {target} and "
                    f"routing: strict forbids the management relay")
            route = Route([direct], direct.cost(n_bytes))
        else:
            two_step = self.two_step_route(source, target, n_bytes)
            route = two_step
            if self.routing != "management":
                direct = self._links.get((source, target))
                if direct is not None \
                        and direct.cost(n_bytes) <= two_step.cost:
                    route = Route([direct], direct.cost(n_bytes))
        if len(self._route_cache) >= self.ROUTE_CACHE_MAX:
            self._route_cache.clear()
        self._route_cache[key] = route
        return route

    def cost(self, source: str, target: str, n_bytes: int) -> float:
        """Route cost in seconds; ``inf`` for a strict-mode unroutable
        pair, so cost-weighted scoring (scheduler, stage-in ordering)
        simply never prefers a placement it could not feed."""
        try:
            return self.route(source, target, n_bytes).cost
        except UnroutableError:
            return float("inf")

    def can_route(self, source: str, target: str) -> bool:
        """Whether any executable route exists (the analyzer's SF303
        reachability predicate — always true outside strict mode)."""
        try:
            self.route(source, target, 0)
        except UnroutableError:
            return False
        return True

    def describe(self) -> List[str]:
        """Human-readable edge list (benchmarks print this)."""
        out = []
        for (a, b), l in sorted(self._links.items()):
            if a == MANAGEMENT:
                continue                 # the star is symmetric; list once
            tag = "mgmt" if b == MANAGEMENT else b
            out.append(f"{a} -> {tag}: latency={l.latency_s}s "
                       f"bw={l.bandwidth_mbps or 'inf'}mbps")
        return out
