"""Static workflow checker: load-time analysis of a StreamFlow document.

The paper's pitch is that a workflow graph plus a declarative description
of the execution environments is *enough* — but only if mistakes in that
description fail at load time instead of mid-run on site 7.  This module
is the analysis pass (cwltool's ``checker.py`` is the exemplar): it walks
the compiled :class:`~repro_torch.core.workflow.Workflow` graphs, the
``bindings:`` and the ``models:`` blocks and reports every problem it can
find as a structured :class:`Diagnostic` (code, location, message).  All
diagnostics are collected before failing — one load surfaces every
mistake, not just the first — and the aggregate is raised as
:class:`WorkflowCheckError`.

The checker deliberately *reuses* the engine's own machinery instead of
reimplementing it: cycles come from ``Workflow.find_cycle()``, stream
geometry (scatter/gather coherence, zip widths) from
``Workflow.stream_geometry()`` with a collecting hook, and binding
resolution from ``match_binding`` — so "checker-accepted" and "expands
without raising" are the same predicate by construction (the conformance
corpus' property test pins this).

Diagnostic codes are stable API (the conformance corpus keys on them):

======  =====================================================
code    meaning
======  =====================================================
SF101   step references an unknown tool
SF102   step wires a slot the tool does not declare
SF103   step omits a required tool input
SF104   step maps an output name the tool does not declare
SF105   tool command template references an unknown placeholder
SF106   invalid type expression
SF107   port type mismatch between producer and consumer
SF108   tool implementation does not resolve/construct
SF110   duplicate port producer
SF111   dangling port reference (no producer, not a workflow input)
SF120   unreachable step (transitively depends on a dangling port)
SF121   workflow cycle
SF130   scatter declared over a scalar port
SF131   gather declared over a scalar port
SF132   stream consumed without a scatter/gather declaration
SF133   scattered slots zip streams of different widths
SF134   slot declared in both scatter and gather
SF135   invalid stream declaration (unknown port / bad width)
SF140   invalid step path
SF150   document declares no workflows (missing/empty section)
SF200   malformed binding target (none, or both target and targets)
SF201   binding references an undeclared model
SF202   binding references a service the model does not declare
SF204   binding path matches no step in the workflow
SF210   step requirements unsatisfiable by every bound target
SF220   scatter block names an unknown step
SF221   scatter block names a slot that is not an input
SF230   autoscale block names an unknown model
SF231   autoscale policy declares min > max replicas
SF232   autoscale marks an external (user-managed) site preemptible
======  =====================================================
"""
from __future__ import annotations

import posixpath
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.deployment import ModelSpec
from repro_torch.core.workflow import (Requirements, Workflow, match_binding)


class StreamFlowFileError(ValueError):
    """A StreamFlow document that cannot be loaded.

    Defined here (not in ``streamflow_file``) so the checker and the
    declarative frontend can raise it without an import cycle;
    ``repro_torch.core.streamflow_file`` re-exports it under its historical
    name, which is the one the public API documents.
    """


#: code -> short human label; the conformance lint asserts every code
#: emitted anywhere in the checker/frontend source appears here AND in at
#: least one invalid-corpus case.
CODES: Dict[str, str] = {
    "SF101": "unknown-tool",
    "SF102": "unknown-input-slot",
    "SF103": "missing-required-input",
    "SF104": "unknown-tool-output",
    "SF105": "unknown-command-placeholder",
    "SF106": "invalid-type-expression",
    "SF107": "port-type-mismatch",
    "SF108": "unresolvable-implementation",
    "SF110": "duplicate-port-producer",
    "SF111": "dangling-port-ref",
    "SF120": "unreachable-step",
    "SF121": "workflow-cycle",
    "SF130": "scatter-over-scalar",
    "SF131": "gather-over-scalar",
    "SF132": "undeclared-stream-input",
    "SF133": "scatter-zip-width-conflict",
    "SF134": "scatter-gather-overlap",
    "SF135": "invalid-stream-declaration",
    "SF140": "invalid-step-path",
    "SF150": "no-workflows-declared",
    "SF200": "invalid-binding-target",
    "SF201": "unknown-binding-model",
    "SF202": "unknown-binding-service",
    "SF204": "binding-matches-no-step",
    "SF210": "unsatisfiable-requirements",
    "SF220": "scatter-block-unknown-step",
    "SF221": "scatter-block-unknown-slot",
    "SF230": "autoscale-unknown-model",
    "SF231": "autoscale-min-exceeds-max",
    "SF232": "autoscale-preemptible-external",
}


@dataclass(frozen=True)
class Diagnostic:
    """One checker finding: a stable code, a JSON-ish document location
    (``workflows.<name>.steps./count``), and a human message."""
    code: str
    location: str
    message: str

    def __str__(self) -> str:
        return f"{self.code} {self.location}: {self.message}"


class WorkflowCheckError(StreamFlowFileError):
    """Raised by ``load()`` after the checker pass: carries *every*
    diagnostic, not just the first."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = list(diagnostics)
        lines = "\n".join(f"  {d}" for d in self.diagnostics)
        super().__init__(
            f"workflow check failed with {len(self.diagnostics)} "
            f"diagnostic(s):\n{lines}")


class Collector:
    """The ``report(code, location, message)`` sink the checks feed."""

    def __init__(self):
        self.diagnostics: List[Diagnostic] = []

    def __call__(self, code: str, location: str, message: str):
        assert code in CODES, f"unregistered diagnostic code {code}"
        d = Diagnostic(code, location, message)
        if d not in self.diagnostics:
            self.diagnostics.append(d)


# ---------------------------------------------------------------------------
# Port type expressions (shared with the declarative frontend)
# ---------------------------------------------------------------------------

#: Leaf type names the ``tools:`` block may use; ``array<T>`` nests.
TYPE_NAMES = frozenset({"any", "int", "float", "string", "bool", "bytes",
                        "record", "file", "array"})

ParsedType = Tuple[str, Optional[Any]]          # (name, element-type | None)


def parse_type(expr: Any) -> Optional[ParsedType]:
    """Parse a port type expression (``int``, ``array<record>``,
    ``array<array<float>>``); None if the expression is invalid."""
    if not isinstance(expr, str):
        return None
    expr = expr.strip()
    if expr.startswith("array<") and expr.endswith(">"):
        inner = parse_type(expr[6:-1])
        return ("array", inner) if inner else None
    if expr in TYPE_NAMES:
        return (expr, None)
    return None


def type_compatible(src: Optional[ParsedType],
                    dst: Optional[ParsedType]) -> bool:
    """Whether a value of type ``src`` may feed a slot of type ``dst``.
    ``any`` unifies with everything; a bare ``array`` matches every
    ``array<T>``; unknown (None) types never fail — they were already
    reported as SF106."""
    if src is None or dst is None:
        return True
    if src[0] == "any" or dst[0] == "any":
        return True
    if src[0] != dst[0]:
        return False
    if src[0] == "array":
        if src[1] is None or dst[1] is None:
            return True
        return type_compatible(src[1], dst[1])
    return True


# ---------------------------------------------------------------------------
# Model / service capabilities (mirrors the Connector implementations)
# ---------------------------------------------------------------------------

#: connector type -> (default cores, default memory_gb) per service, kept
#: in lockstep with connectors/local.py and connectors/mesh.py.
_CONNECTOR_DEFAULTS: Dict[str, Tuple[int, float]] = {
    "local": (1, 4.0),
    "mesh": (8, 64.0),
    "multipod": (8, 64.0),
}


def service_capabilities(spec: ModelSpec) -> Dict[str, Requirements]:
    """What each service of a model can offer a step, *without deploying
    it*: service name -> per-replica Requirements ceiling.  Follows the
    same config conventions the Connector implementations apply at
    ``deploy()`` (missing ``services`` means one ``default`` service;
    simcluster delegates to its inner connector)."""
    cfg = spec.config or {}
    if spec.type == "simcluster":
        inner = cfg.get("inner", {"type": "local", "config": {}})
        return service_capabilities(ModelSpec(
            spec.name, inner.get("type", "local"),
            inner.get("config", {}) or {}))
    cores_d, mem_d = _CONNECTOR_DEFAULTS.get(spec.type, (1, 4.0))
    services = cfg.get("services") or {"default": {"replicas": 1}}
    out: Dict[str, Requirements] = {}
    for svc, scfg in services.items():
        scfg = scfg or {}
        out[svc] = Requirements(cores=int(scfg.get("cores", cores_d)),
                                memory_gb=float(scfg.get("memory_gb", mem_d)))
    return out


def service_slots(spec: ModelSpec) -> Dict[str, int]:
    """How many resources each service of a model deploys, statically:
    service name -> replica count, following the same ``replicas``
    convention every Connector applies at ``deploy()`` (default 1;
    ``replicas: 0`` legally deploys an empty service — the analyzer's
    zero-slot wedge vector).  Simcluster delegates to its inner
    connector, like :func:`service_capabilities`."""
    cfg = spec.config or {}
    if spec.type == "simcluster":
        inner = cfg.get("inner", {"type": "local", "config": {}})
        return service_slots(ModelSpec(
            spec.name, inner.get("type", "local"),
            inner.get("config", {}) or {}))
    services = cfg.get("services") or {"default": {"replicas": 1}}
    return {svc: int((scfg or {}).get("replicas", 1))
            for svc, scfg in services.items()}


# ---------------------------------------------------------------------------
# Graph checks
# ---------------------------------------------------------------------------

def check_graph(wf: Workflow, name: str,
                report: Callable[[str, str, str], None]):
    """Structural checks on one compiled workflow: cycles, dangling and
    unreachable ports/steps, stream geometry, port types.

    Dangling/unreachable and type checks only fire when the frontend
    annotated the workflow (``declared_inputs`` / ``slot_types`` /
    ``port_types`` attributes); Python-built workflows take their inputs
    at run time, so an unproduced port is an argument, not an error.
    """
    loc = f"workflows.{name}"
    trail = wf.find_cycle()
    if trail is not None:
        report("SF121", loc,
               f"cycle through {trail[-1]}: {' -> '.join(trail)}")
        return                       # geometry/reachability undefined

    declared_inputs = getattr(wf, "declared_inputs", None)
    dangling: set = set()
    if declared_inputs is not None:
        for path, step in wf.steps.items():
            for slot, port in step.inputs.items():
                if wf.producer_of(port) is None \
                        and port not in declared_inputs:
                    dangling.add(port)
                    report("SF111", f"{loc}.steps.{path}",
                           f"step {path}: slot {slot!r} consumes port "
                           f"{port!r}, which no step produces and which is "
                           f"not a declared workflow input")
        if dangling:
            blocked = {p for p, s in wf.steps.items()
                       if dangling & set(s.inputs.values())}
            changed = True
            while changed:
                changed = False
                for path, step in wf.steps.items():
                    if path in blocked:
                        continue
                    if any(wf.producer_of(p) in blocked
                           for p in step.inputs.values()):
                        blocked.add(path)
                        changed = True
            direct = {p for p, s in wf.steps.items()
                      if dangling & set(s.inputs.values())}
            for path in sorted(blocked - direct):
                report("SF120", f"{loc}.steps.{path}",
                       f"step {path} is unreachable: it transitively "
                       f"depends on undefined port(s) "
                       f"{sorted(dangling)}")

    geometry_kind_codes = {"scatter-scalar": "SF130",
                          "gather-scalar": "SF131",
                          "stream-undeclared": "SF132",
                          "zip-width": "SF133"}

    def on_geometry(kind: str, path: str, message: str):
        report(geometry_kind_codes[kind], f"{loc}.steps.{path}", message)

    wf.stream_geometry(on_error=on_geometry)

    slot_types = getattr(wf, "slot_types", None)
    port_types = getattr(wf, "port_types", None)
    if not slot_types or port_types is None:
        return
    for (path, slot), dst_expr in slot_types.items():
        step = wf.steps.get(path)
        if step is None or slot not in step.inputs:
            continue
        port = step.inputs[slot]
        src_expr = port_types.get(port)
        if src_expr is None:
            continue                 # untyped (e.g. dangling) port
        src = parse_type(src_expr)
        dst = parse_type(dst_expr)
        if src is None or dst is None:
            continue                 # SF106 already reported
        # a port's declared type describes ONE token on the port (the
        # per-element/per-invocation value); cardinality lives in
        # streams:/scatter declarations, not the type.  So a scattered
        # slot compares element-to-element, while a gathered slot
        # receives the whole stream as a list — array<T>.
        shown = src_expr
        if slot in step.gather:
            src = ("array", src)
            shown = f"array<{src_expr}> (gathered stream of {src_expr})"
        if not type_compatible(src, dst):
            report("SF107", f"{loc}.steps.{path}",
                   f"step {path}: slot {slot!r} expects {dst_expr} but "
                   f"port {port!r} carries {shown}")


# ---------------------------------------------------------------------------
# Binding + requirements checks
# ---------------------------------------------------------------------------

def _targets_of(entry: dict) -> List[dict]:
    if "targets" in entry:
        return list(entry["targets"])
    if "target" in entry:
        return [entry["target"]]
    return []


def check_bindings(name: str, wf: Workflow, raw_bindings: List[dict],
                   models: Dict[str, ModelSpec],
                   report: Callable[[str, str, str], None]):
    """Bindings vs. the declared environments: malformed targets, unknown
    models/services, binding paths that match nothing, and per-step
    requirements no bound target can satisfy (paper §4.4's admission
    question, answered statically)."""
    loc = f"workflows.{name}"
    usable_paths: List[str] = []
    for i, entry in enumerate(raw_bindings):
        bloc = f"{loc}.bindings[{i}]"
        has_one = "target" in entry
        has_many = "targets" in entry
        if not has_one and not has_many:
            report("SF200", bloc,
                   f"binding {entry['step']}: needs a target (or targets)")
            continue
        if has_one and has_many:
            report("SF200", bloc,
                   f"binding {entry['step']}: give target OR targets, "
                   f"not both (ambiguous)")
            continue
        for tgt in _targets_of(entry):
            model = models.get(tgt["model"])
            if model is None:
                report("SF201", bloc,
                       f"binding {entry['step']}: unknown model "
                       f"{tgt['model']!r}")
            else:
                caps = service_capabilities(model)
                if tgt["service"] not in caps:
                    report("SF202", bloc,
                           f"binding {entry['step']}: model "
                           f"{tgt['model']!r} declares no service "
                           f"{tgt['service']!r} (have {sorted(caps)})")
        usable_paths.append(entry["step"])
        norm = posixpath.normpath(entry["step"])
        if norm != "/" and not any(
                p == norm or p.startswith(norm.rstrip("/") + "/")
                for p in wf.steps):
            report("SF204", bloc,
                   f"binding {entry['step']}: matches no step in "
                   f"workflow {name!r} (steps: {sorted(wf.steps)})")

    # requirements satisfiability, through the same deepest-path-wins
    # resolution the executor applies
    by_norm = {posixpath.normpath(e["step"]): e
               for e in raw_bindings if _targets_of(e)}
    for path, step in wf.steps.items():
        best = match_binding(path, usable_paths)
        if best is None:
            continue                 # unbound: legal until the step runs
        entry = by_norm.get(best)
        if entry is None:
            continue
        req = step.requirements
        known = []
        for tgt in _targets_of(entry):
            model = models.get(tgt["model"])
            if model is None:
                continue
            caps = service_capabilities(model)
            if tgt["service"] in caps:
                known.append((tgt, caps[tgt["service"]]))
        if not known:
            continue                 # every target already SF201/SF202
        if not any(cap.cores >= req.cores and cap.memory_gb >= req.memory_gb
                   for _, cap in known):
            offers = ", ".join(
                f"{t['model']}/{t['service']} (cores={c.cores}, "
                f"memory_gb={c.memory_gb:g})" for t, c in known)
            report("SF210", f"{loc}.steps.{path}",
                   f"step {path} requires cores>={req.cores}, "
                   f"memory_gb>={req.memory_gb:g}, but no bound target "
                   f"satisfies it: {offers}")


def check_autoscale(block: dict, models: Dict[str, ModelSpec],
                    report: Callable[[str, str, str], None]):
    """The ``autoscale:`` block vs. the declared environments: per-model
    policies must name a declared model (SF230), keep ``min <= max``
    (SF231), and never mark an ``external: true`` site preemptible
    (SF232) — a user-managed site is not the engine's to revoke."""
    for name, pol in (block.get("models") or {}).items():
        loc = f"autoscale.models.{name}"
        pol = pol or {}
        model = models.get(name)
        if model is None:
            report("SF230", loc,
                   f"autoscale names unknown model {name!r} "
                   f"(have {sorted(models)})")
            continue
        lo, hi = pol.get("min", 1), pol.get("max", 1)
        if isinstance(lo, (int, float)) and isinstance(hi, (int, float)) \
                and lo > hi:
            report("SF231", loc,
                   f"min replicas ({lo}) exceeds max ({hi})")
        if pol.get("preemptible") and model.external:
            report("SF232", loc,
                   f"model {name!r} is external (user-managed): the "
                   f"engine cannot revoke a site it does not deploy")


# ---------------------------------------------------------------------------
# Dry run
# ---------------------------------------------------------------------------

def dry_run(entry: Any) -> Dict[str, Any]:
    """Expand one loaded workflow into its invocation plan *without
    executing anything*: the plan summary plus the (model, service)
    targets each invocation would be allowed to run on.  This is what
    ``streamflow check --plan`` prints and what the conformance corpus'
    valid cases assert against."""
    plan = entry.workflow.expand()
    summary = plan.summary()
    binding_paths = [b.step for b in entry.bindings]
    by_norm = {posixpath.normpath(b.step): b for b in entry.bindings}
    for ipath, inv in summary["invocations"].items():
        best = match_binding(ipath, binding_paths)
        b = by_norm.get(best) if best is not None else None
        inv["targets"] = ([list(t) for t in b.targets] if b else [])
    return summary
