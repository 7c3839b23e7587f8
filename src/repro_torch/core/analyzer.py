"""Plan-time semantic analyzer: the SF3xx diagnostic family.

The SF1xx/SF2xx checker (PR 8) proves *shape*: graphs compile, bindings
name real services, declared requirements fit some target's per-replica
capability.  Whole classes of guaranteed-to-fail plans still slip
through it — a scatter bound to a service that deploys ``replicas: 0``,
a step no binding matches (the executor raises ``KeyError`` on the first
scheduling tick), a ``routing: strict`` topology that partitions a
producer from every consumer.  Today those surface at runtime, possibly
hours into a batch allocation, as a deadlock-guard trip or a mid-run
crash.

This module proves them statically, over the *expanded*
:class:`~repro_torch.core.workflow.InvocationPlan` joined with the declared
environment: service capabilities + replica counts
(:func:`~repro_torch.core.checker.service_capabilities` /
:func:`~repro_torch.core.checker.service_slots`), the ``autoscale:`` replica
envelope (:func:`~repro_torch.core.autoscale.scale_envelope`), the
``topology:`` link graph, and optionally the scheduler's live registered
capacity (:meth:`~repro_torch.core.scheduler.Scheduler.export_capacity`).

======  ==============================================================
code    meaning
======  ==============================================================
SF300   gather barrier over a scatter group with zero schedulable
        slots even at max scale — the run provably wedges (error)
SF301   invocation's requirements + replica counts leave zero
        accepting slots at max scale (error; today a runtime
        deadlock-guard trip)
SF302   invocation matches no binding — the executor raises KeyError
        on its first scheduling tick (error)
SF303   under ``routing: strict``, a token's producer sites share no
        route with any consumer site (error; runtime UnroutableError)
SF310   gather barrier serializes: fewer concurrent slots than the
        scatter width, so the fan-out runs in waves (warning)
SF311   inter-site data that can only move through the management
        relay — the paper's R3 bottleneck, with byte volume (warning)
SF312   cache enabled + zero-input invocation: the memo key degrades
        to step identity, so stale hits survive input changes
        (warning)
======  ==============================================================

Alongside the proofs runs a **static cost engine**: per-step cost
estimates (the ``analyze:`` block's ``costs:`` map, or a caller-supplied
calibration) walked over the plan with the PR-4
:class:`~repro_torch.core.topology.TopologyGraph` link costs yield the
critical path, a makespan lower bound (critical path vs. total work
over the joint slot bound vs. per-target exclusive work), and per-link
byte volumes.  ``benchmarks/bench_analyze.py`` gates the bound against
measured makespans in CI.

Everything here is read-only and opt-in: ``analyze: off`` (or an absent
block) means :class:`WorkflowService` never calls this module and the
engine behaves byte-identically to its pre-analyzer self.
"""
from __future__ import annotations

import math
import posixpath
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.autoscale import ScaleEnvelope, scale_envelope
from repro_torch.core.checker import (Diagnostic, StreamFlowFileError,
                                service_capabilities, service_slots)
from repro_torch.core.topology import TopologyGraph
from repro_torch.core.workflow import match_binding, parse_token_ref

#: code -> short human label; the conformance lint asserts every SF3xx
#: code emitted by this module appears here AND in at least one
#: analysis-corpus case (mirror of ``checker.CODES`` for load-time codes).
CODES: Dict[str, str] = {
    "SF300": "gather-barrier-deadlock",
    "SF301": "placement-unsatisfiable",
    "SF302": "unbound-invocation",
    "SF303": "data-unreachable",
    "SF310": "gather-barrier-serializes",
    "SF311": "management-bottleneck",
    "SF312": "cache-unsound-step",
}

#: code -> severity; ``fail_on: warning`` promotes warnings to gate
#: failures, the default gate only fails on errors.
SEVERITY: Dict[str, str] = {
    "SF300": "error",
    "SF301": "error",
    "SF302": "error",
    "SF303": "error",
    "SF310": "warning",
    "SF311": "warning",
    "SF312": "warning",
}


@dataclass(frozen=True)
class AnalyzeConfig:
    """Parsed ``analyze:`` block (the submit-gate configuration)."""
    enabled: bool = True
    fail_on: str = "error"                 # "error" | "warning"
    default_cost_s: float = 0.0
    costs: Dict[str, float] = field(default_factory=dict)

    @classmethod
    def from_value(cls, v: Any) -> Optional["AnalyzeConfig"]:
        """Normalize the StreamFlow file's ``analyze:`` value.  Accepts
        the mapping form, plain booleans (YAML ``analyze: off`` parses to
        False), or absence — anything disabled returns None, which is
        the engine's pre-analyzer behaviour switch (mirrors
        ``persistence.CacheConfig.from_value``)."""
        if v is None or v is False or v == {}:
            return None
        if v is True:
            return cls()
        if not isinstance(v, dict):
            raise ValueError(f"analyze: must be a mapping or a boolean, "
                             f"not {type(v).__name__}")
        unknown = set(v) - {"enabled", "fail_on", "default_cost_s", "costs"}
        if unknown:
            raise ValueError(f"analyze: unknown key(s) {sorted(unknown)}")
        if not v.get("enabled", True):
            return None
        fail_on = v.get("fail_on", "error")
        if fail_on not in ("error", "warning"):
            raise ValueError(f"analyze.fail_on: {fail_on!r} is not "
                             f"'error' or 'warning'")
        return cls(enabled=True, fail_on=fail_on,
                   default_cost_s=float(v.get("default_cost_s", 0.0)),
                   costs={k: float(x)
                          for k, x in (v.get("costs") or {}).items()})


class WorkflowAnalysisError(StreamFlowFileError):
    """Raised by the submit gate: carries every SF3xx diagnostic at or
    above the configured ``fail_on`` severity (plus the full report)."""

    def __init__(self, diagnostics: List[Diagnostic],
                 report: "AnalysisReport"):
        self.diagnostics = list(diagnostics)
        self.report = report
        lines = "\n".join(f"  {d}" for d in self.diagnostics)
        super().__init__(
            f"workflow analysis failed with {len(self.diagnostics)} "
            f"diagnostic(s):\n{lines}")


@dataclass
class AnalysisReport:
    """Everything one :func:`analyze` pass proved: the SF3xx diagnostics
    plus the per-workflow static cost report."""
    diagnostics: List[Diagnostic] = field(default_factory=list)
    cost: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if SEVERITY.get(d.code) == "error"]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics
                if SEVERITY.get(d.code) == "warning"]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "diagnostics": [{"code": d.code,
                             "severity": SEVERITY.get(d.code, "error"),
                             "location": d.location,
                             "message": d.message}
                            for d in self.diagnostics],
            "cost": self.cost,
        }


class _Collector:
    """Analyzer-side ``report(code, location, message)`` sink (same
    dedup contract as ``checker.Collector``, but registered against the
    SF3xx table)."""

    def __init__(self):
        self.diagnostics: List[Diagnostic] = []

    def __call__(self, code: str, location: str, message: str):
        assert code in CODES, f"unregistered analyzer code {code}"
        d = Diagnostic(code, location, message)
        if d not in self.diagnostics:
            self.diagnostics.append(d)


# ---------------------------------------------------------------------------
# Environment capacity model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Target:
    """One accepting (model, service) with its static slot accounting."""
    model: str
    service: str
    per_site_slots: int                    # replicas of this service/site
    max_slots: int                         # across every site at max scale


class _Capacity:
    """Joins declared capabilities + replica counts + the autoscale
    envelope (+ optionally live scheduler capacity) into one question:
    which targets *accept* an invocation, and with how many slots."""

    def __init__(self, models: Dict[str, Any], autoscale_block: Any,
                 live_capacity: Optional[Dict[Tuple[str, str], int]] = None):
        self.caps = {m: service_capabilities(spec)
                     for m, spec in models.items()}
        self.slots = {m: service_slots(spec) for m, spec in models.items()}
        self.env: ScaleEnvelope = scale_envelope(autoscale_block, models)
        self.live = live_capacity or {}

    def max_sites(self, model: str) -> int:
        return self.env.max_sites([model])

    def accepting(self, requirements, targets: Sequence[Tuple[str, str]]
                  ) -> List[_Target]:
        """Targets that can run an invocation with ``requirements``,
        with more than zero slots once replica counts, the autoscale
        envelope and (if given) live registered capacity are accounted.
        Targets the SF2xx checker already rejects (unknown model or
        service) are skipped, not re-reported."""
        out: List[_Target] = []
        for model, service in targets:
            caps = self.caps.get(model)
            if caps is None or service not in caps:
                continue
            cap = caps[service]
            if cap.cores < requirements.cores \
                    or cap.memory_gb < requirements.memory_gb:
                continue
            per_site = self.slots.get(model, {}).get(service, 0)
            max_slots = per_site * self.max_sites(model)
            live = self.live.get((model, service))
            if live is not None:
                # a pool may hold more than the document declares (e.g.
                # replicas a previous run scaled up); never less credit
                max_slots = max(max_slots, live)
                if per_site == 0:
                    per_site = live
            if max_slots > 0:
                out.append(_Target(model, service, per_site, max_slots))
        return out

    def joint_slots(self, targets: Sequence[_Target]) -> int:
        """Upper bound on *concurrently occupied* slots across a target
        set: base sites contribute their per-site slots once per distinct
        (model, service); extra replica sites are a shared
        ``max_total_replicas`` budget, allocated greedily to the models
        whose sites carry the most slots (an upper bound, which is the
        safe direction for a serialization warning and for dividing work
        in the makespan lower bound)."""
        pairs: Dict[Tuple[str, str], int] = {}
        for t in targets:
            pairs[(t.model, t.service)] = t.per_site_slots
        base = sum(pairs.values())
        per_model_site_slots: Dict[str, int] = {}
        for (model, _svc), n in pairs.items():
            per_model_site_slots[model] = \
                per_model_site_slots.get(model, 0) + n
        budget = self.env.max_total_extras
        extra = 0
        for model in sorted(per_model_site_slots,
                            key=lambda m: -per_model_site_slots[m]):
            headroom = self.env.per_model.get(model, 1) - 1
            take = headroom if budget is None else min(headroom, budget)
            extra += take * per_model_site_slots[model]
            if budget is not None:
                budget -= take
        live = sum(n for (m, s), n in self.live.items() if (m, s) in pairs)
        return max(base + extra, live)


# ---------------------------------------------------------------------------
# The analysis pass
# ---------------------------------------------------------------------------

def _gathered_refs(inv) -> List[str]:
    """Token refs feeding an invocation's gather barrier(s)."""
    widths = getattr(inv, "_gather_widths", {})
    if not widths:
        return []
    out = []
    for key, ref in inv.inputs.items():
        base, tag = parse_token_ref(key)
        if base in widths and tag:
            out.append(ref)
    return out


def _resolve(entry, plan):
    """Per declared step: its binding targets (or None if unbound),
    through the executor's deepest-path-wins resolution."""
    binding_paths = [b.step for b in entry.bindings]
    by_norm = {posixpath.normpath(b.step): b for b in entry.bindings}
    resolved: Dict[str, Optional[List[Tuple[str, str]]]] = {}
    for ipath, inv in plan.steps.items():
        spath = inv.step.path
        if spath in resolved:
            continue
        best = match_binding(ipath, binding_paths)
        b = by_norm.get(best) if best is not None else None
        resolved[spath] = list(b.targets) if b is not None else None
    return resolved


def analyze(cfg, *, step_costs: Optional[Dict[str, float]] = None,
            default_cost_s: Optional[float] = None,
            live_capacity: Optional[Dict[Tuple[str, str], int]] = None
            ) -> AnalysisReport:
    """Run every SF3xx proof + the static cost engine over a loaded
    :class:`~repro_torch.core.streamflow_file.StreamFlowConfig`.

    ``step_costs`` (declared step path -> seconds) and
    ``default_cost_s`` override the document's ``analyze:`` block;
    ``live_capacity`` substitutes the scheduler's registered
    (model, service) -> slot counts for the declared replica counts.
    Pure function: nothing is deployed, executed, or mutated.
    """
    block = AnalyzeConfig.from_value(getattr(cfg, "analyze", None)) \
        or AnalyzeConfig()
    costs_map = dict(block.costs)
    if step_costs:
        costs_map.update(step_costs)
    default_cost = (block.default_cost_s if default_cost_s is None
                    else float(default_cost_s))

    report = _Collector()
    capacity = _Capacity(cfg.models, getattr(cfg, "autoscale", {}),
                         live_capacity)
    topo = TopologyGraph.from_config(cfg.models,
                                     getattr(cfg, "topology", {}) or {})
    strict = topo.routing == "strict"
    cache_on = _cache_enabled(getattr(cfg, "cache", {}))
    cost_report: Dict[str, Dict[str, Any]] = {}

    for name, entry in cfg.workflows.items():
        plan = entry.workflow.expand()
        loc = f"workflows.{name}"
        resolved = _resolve(entry, plan)

        # -- SF301 / SF302: satisfiability per declared step ----------------
        accepting: Dict[str, List[_Target]] = {}
        for spath, targets in resolved.items():
            step = entry.workflow.steps.get(spath)
            req = step.requirements if step is not None else None
            if targets is None:
                report("SF302", f"{loc}.steps.{spath}",
                       f"step {spath} matches no binding: the executor "
                       f"raises KeyError on its first scheduling tick")
                accepting[spath] = []
                continue
            acc = capacity.accepting(req, targets)
            accepting[spath] = acc
            if not acc:
                offers = ", ".join(
                    f"{m}/{s} (cores={capacity.caps[m][s].cores}, "
                    f"memory_gb={capacity.caps[m][s].memory_gb:g}, "
                    f"max_slots="
                    f"{capacity.slots[m].get(s, 0) * capacity.max_sites(m)})"
                    for m, s in targets
                    if m in capacity.caps and s in capacity.caps[m])
                report("SF301", f"{loc}.steps.{spath}",
                       f"step {spath} requires cores>={req.cores}, "
                       f"memory_gb>={req.memory_gb:g} but no bound target "
                       f"accepts it with >0 slots at max scale"
                       + (f": {offers}" if offers else
                          " (every target unknown to the environment)"))

        # -- SF300 / SF310: gather barriers vs. schedulable slots -----------
        seen_barriers = set()
        for ipath, inv in plan.steps.items():
            refs = _gathered_refs(inv)
            if not refs or inv.step.path in seen_barriers:
                continue
            seen_barriers.add(inv.step.path)
            producers = {plan.producer_of(r) for r in refs}
            producers.discard(None)
            prod_steps = {plan.steps[p].step.path for p in producers}
            if not prod_steps:
                continue                 # gathered refs are external inputs
            group = [t for sp in prod_steps for t in accepting.get(sp, [])]
            width = len(refs)
            if all(not accepting.get(sp) for sp in prod_steps):
                report("SF300", f"{loc}.steps.{inv.step.path}",
                       f"gather barrier over {width} token(s) from "
                       f"{sorted(prod_steps)} can wedge: zero schedulable "
                       f"slots across every target even at max scale — "
                       f"the barrier waits forever")
                continue
            slots = capacity.joint_slots(group)
            if 0 < slots < len(producers):
                waves = math.ceil(len(producers) / slots)
                report("SF310", f"{loc}.steps.{inv.step.path}",
                       f"gather barrier waits on {len(producers)} "
                       f"invocation(s) but their targets offer at most "
                       f"{slots} concurrent slot(s) at max scale: the "
                       f"scatter serializes into ~{waves} waves")

        # -- SF303: strict-routing reachability ------------------------------
        if strict:
            seen_edges = set()
            for ipath, inv in plan.steps.items():
                cons_sites = {t.model for t in
                              accepting.get(inv.step.path, [])}
                if not cons_sites:
                    continue
                for p in plan.predecessors(ipath):
                    pstep = plan.steps[p].step.path
                    edge = (pstep, inv.step.path)
                    if edge in seen_edges:
                        continue
                    seen_edges.add(edge)
                    prod_sites = {t.model for t in accepting.get(pstep, [])}
                    if not prod_sites:
                        continue
                    if not any(topo.can_route(sp, sc)
                               for sp in prod_sites for sc in cons_sites):
                        report("SF303", f"{loc}.steps.{inv.step.path}",
                               f"step {inv.step.path} consumes tokens "
                               f"produced on {sorted(prod_sites)} but "
                               f"routing: strict declares no link to any "
                               f"of its sites {sorted(cons_sites)} — the "
                               f"transfer is unexecutable")

        # -- SF312: cache-unsound steps --------------------------------------
        if cache_on:
            seen_zero = set()
            for ipath, inv in plan.steps.items():
                if inv.inputs or inv.step.path in seen_zero:
                    continue
                seen_zero.add(inv.step.path)
                report("SF312", f"{loc}.steps.{inv.step.path}",
                       f"step {inv.step.path} has zero input tokens while "
                       f"the invocation cache is enabled: its memo key "
                       f"degrades to step identity, so a cached result "
                       f"survives changes the key cannot see")

        # -- cost engine (also detects the forced-relay volume for SF311) ----
        wf_cost = _cost_engine(plan, accepting, topo, costs_map,
                               default_cost, capacity)
        cost_report[name] = wf_cost
        if wf_cost["forced_mgmt_bytes"] > 0 and not strict:
            report("SF311", f"{loc}",
                   f"{wf_cost['forced_mgmt_bytes']} byte(s) across "
                   f"{wf_cost['forced_mgmt_transfers']} inter-site "
                   f"transfer(s) can only move through the management "
                   f"relay (no direct link between any placement pair) — "
                   f"the paper's R3 bottleneck; declare topology links "
                   f"to route around it")

    return AnalysisReport(diagnostics=report.diagnostics, cost=cost_report)


def _cache_enabled(value: Any) -> bool:
    try:
        from repro_torch.core.persistence import CacheConfig
        return CacheConfig.from_value(value) is not None
    except ValueError:
        return False


def _cost_engine(plan, accepting: Dict[str, List[_Target]],
                 topo: TopologyGraph, costs_map: Dict[str, float],
                 default_cost: float, capacity: _Capacity
                 ) -> Dict[str, Any]:
    """Critical path + makespan lower bound + per-link byte volumes.

    Every choice is *optimistic* (cheapest placement pair per edge, the
    joint slot upper bound dividing total work), so the emitted
    ``makespan_lower_bound_s`` is a true lower bound whenever the
    per-step costs are themselves not overestimates."""
    node_cost = {ipath: costs_map.get(inv.step.path, default_cost)
                 for ipath, inv in plan.steps.items()}
    sites_of = {spath: [t.model for t in targets]
                for spath, targets in accepting.items()}

    def edge(p_ipath: str, c_ipath: str
             ) -> Tuple[float, Optional[Tuple[str, str]], int]:
        """(cost_s, chosen (src, dst) site pair, bytes) for one token
        hand-off, over the cheapest placement pair."""
        p_inv, c_inv = plan.steps[p_ipath], plan.steps[c_ipath]
        n_bytes = max(int(p_inv.est_output_bytes), 0)
        srcs = sites_of.get(p_inv.step.path) or []
        dsts = sites_of.get(c_inv.step.path) or []
        best: Tuple[float, Optional[Tuple[str, str]]] = (0.0, None)
        found = False
        for sp in srcs:
            for sc in dsts:
                c = topo.cost(sp, sc, n_bytes)
                if c == float("inf"):
                    continue             # strict-unroutable pair
                if not found or c < best[0]:
                    best, found = (c, (sp, sc)), True
        return best[0], best[1], n_bytes

    # longest path over the DAG, iterative post-order (plans can be deep)
    dist: Dict[str, float] = {}
    via: Dict[str, Optional[str]] = {}
    stack = [(ip, False) for ip in plan.steps]
    while stack:
        ipath, expanded = stack.pop()
        if ipath in dist:
            continue
        preds = plan.predecessors(ipath)
        if not expanded:
            stack.append((ipath, True))
            stack.extend((p, False) for p in preds if p not in dist)
            continue
        best_d: float = 0.0
        best_p: Optional[str] = None
        for p in preds:
            ec, _pair, _b = edge(p, ipath)
            d = dist[p] + ec
            if best_p is None or d > best_d:
                best_d, best_p = d, p
        dist[ipath] = best_d + node_cost[ipath]
        via[ipath] = best_p

    critical_path_s = max(dist.values(), default=0.0)
    chain: List[str] = []
    if dist:
        cur: Optional[str] = max(dist, key=lambda k: dist[k])
        while cur is not None:
            chain.append(cur)
            cur = via.get(cur)
        chain.reverse()

    # work bounds: total work over the joint slot ceiling, plus per-target
    # exclusive work (invocations only one target accepts cannot borrow
    # anyone else's slots)
    total_work = sum(node_cost.values())
    all_targets = [t for ts in accepting.values() for t in ts]
    joint = capacity.joint_slots(all_targets)
    bounds = [critical_path_s]
    if joint > 0:
        bounds.append(total_work / joint)
    excl_work: Dict[Tuple[str, str], float] = {}
    excl_slots: Dict[Tuple[str, str], int] = {}
    for ipath, inv in plan.steps.items():
        ts = accepting.get(inv.step.path) or []
        if len(ts) == 1:
            key = (ts[0].model, ts[0].service)
            excl_work[key] = excl_work.get(key, 0.0) + node_cost[ipath]
            excl_slots[key] = ts[0].max_slots
    for key, work in excl_work.items():
        if excl_slots.get(key):
            bounds.append(work / excl_slots[key])

    # per-link byte volumes, charged to the cheapest route's hops;
    # forced-relay volume = edges where every placement pair is
    # cross-site AND relays (no direct link, no shared site)
    link_bytes: Dict[str, int] = {}
    mgmt_bytes = 0
    forced_bytes = 0
    forced_transfers = 0
    for ipath in plan.steps:
        for p in plan.predecessors(ipath):
            ec, pair, n_bytes = edge(p, ipath)
            if pair is None or n_bytes == 0:
                continue
            sp, sc = pair
            if sp != sc:
                try:
                    route = topo.route(sp, sc, n_bytes)
                except Exception:
                    continue
                for hop in route.hops:
                    key = f"{hop.source}->{hop.target}"
                    link_bytes[key] = link_bytes.get(key, 0) + n_bytes
                if route.via_management:
                    mgmt_bytes += n_bytes
            p_inv = plan.steps[p]
            srcs = sites_of.get(p_inv.step.path) or []
            dsts = sites_of.get(plan.steps[ipath].step.path) or []
            pairs = [(a, b) for a in srcs for b in dsts]
            if pairs and all(a != b and topo.link(a, b) is None
                             for a, b in pairs):
                forced_bytes += n_bytes
                forced_transfers += 1

    return {
        "critical_path": [plan.steps[ip].path for ip in chain],
        "critical_path_s": round(critical_path_s, 6),
        "total_work_s": round(total_work, 6),
        "max_parallel_slots": joint,
        "makespan_lower_bound_s": round(max(bounds), 6),
        "link_bytes": link_bytes,
        "mgmt_bytes": mgmt_bytes,
        "forced_mgmt_bytes": forced_bytes,
        "forced_mgmt_transfers": forced_transfers,
        "n_invocations": len(plan.steps),
    }


def gate(cfg, *, live_capacity: Optional[Dict[Tuple[str, str], int]] = None
         ) -> Optional[AnalysisReport]:
    """The ``analyze:`` submit gate.  Returns None when the block is
    absent/off (the engine's pre-analyzer path, untouched); otherwise
    runs :func:`analyze` and raises :class:`WorkflowAnalysisError` if any
    diagnostic reaches the block's ``fail_on`` severity."""
    block = AnalyzeConfig.from_value(getattr(cfg, "analyze", None))
    if block is None:
        return None
    report = analyze(cfg, live_capacity=live_capacity)
    failing = report.errors()
    if block.fail_on == "warning":
        failing = list(report.diagnostics)
    if failing:
        raise WorkflowAnalysisError(failing, report)
    return report
