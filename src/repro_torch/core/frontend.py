"""Declarative tool/step frontend: workflows from configuration alone.

The CWL-inspired half of ROADMAP item 3 (cwltool's ``load_tool.py`` /
``factory.py`` are the exemplars).  A ``tools:`` block declares reusable
tool interfaces — a command template, typed input/output ports, resource
requirements, optionally a Python implementation — and a workflow with
``type: declarative`` wires tools into the Port/Token graph straight
from the StreamFlow file::

    tools:
      count:
        command: "cellranger count --shard {shard}"
        inputs:  {shard: record}
        outputs: {model: array<record>}
        requirements: {cores: 1, memory_gb: 2}
    workflows:
      single-cell:
        type: declarative
        inputs: {seed: int}
        steps:
          /count:
            tool: count
            in: {shard: shards}
            scatter: [shard]
        bindings: [...]

:func:`compile_declarative` produces exactly the
:class:`~repro_torch.core.workflow.Workflow` a hand-written Python builder
would have (same step paths, port wiring, scatter/gather/streams
declarations, requirements), so everything downstream — expansion,
scheduling, the data plane, the journal — is frontend-blind; the
conformance suite pins plan-identity against the §5 pipeline builders.

Error handling is two-mode.  With ``collect=None`` the first problem
raises :class:`~repro_torch.core.checker.StreamFlowFileError` (the lazy
behaviour ``check: off`` preserves); with a collector callback every
problem is reported as a structured diagnostic and compilation recovers
with a best-effort skeleton, so the static checker keeps finding
graph-level mistakes in the same pass.
"""
from __future__ import annotations

import importlib
import string
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.checker import StreamFlowFileError, parse_type
from repro_torch.core.workflow import (INVOCATION_SEP, Requirements, Step,
                                 Workflow)
import posixpath

Report = Callable[[str, str, str], None]


# ---------------------------------------------------------------------------
# Tool specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ToolInput:
    """One declared tool input: a slot name, a port type expression, and
    optionally a default (which also makes the slot optional)."""
    name: str
    type: str = "any"
    optional: bool = False
    default: Any = None
    has_default: bool = False


@dataclass
class ToolSpec:
    """A reusable tool interface from the ``tools:`` block."""
    name: str
    command: Optional[str] = None
    inputs: Dict[str, ToolInput] = field(default_factory=dict)
    outputs: Dict[str, str] = field(default_factory=dict)  # name -> type
    requirements: Requirements = Requirements()
    est_output_bytes: int = 0
    implementation: Optional[Dict[str, Any]] = None

    @property
    def required_inputs(self) -> List[str]:
        return [n for n, i in self.inputs.items()
                if not (i.optional or i.has_default)]


def _parse_requirements(rcfg: Optional[dict]) -> Tuple[Requirements, int]:
    rcfg = rcfg or {}
    return (Requirements(cores=int(rcfg.get("cores", 1)),
                         memory_gb=float(rcfg.get("memory_gb", 1.0))),
            int(rcfg.get("est_output_bytes", 0)))


def parse_tools(block: Optional[dict]) -> Dict[str, ToolSpec]:
    """Parse the ``tools:`` block (already schema-validated) into specs."""
    tools: Dict[str, ToolSpec] = {}
    for name, tcfg in (block or {}).items():
        tcfg = tcfg or {}
        inputs: Dict[str, ToolInput] = {}
        for iname, icfg in (tcfg.get("inputs") or {}).items():
            if isinstance(icfg, str):
                icfg = {"type": icfg}
            icfg = icfg or {}
            inputs[iname] = ToolInput(
                name=iname, type=icfg.get("type", "any"),
                optional=bool(icfg.get("optional", False)),
                default=icfg.get("default"),
                has_default="default" in icfg)
        outputs: Dict[str, str] = {}
        for oname, ocfg in (tcfg.get("outputs") or {}).items():
            outputs[oname] = (ocfg if isinstance(ocfg, str)
                              else (ocfg or {}).get("type", "any"))
        req, est = _parse_requirements(tcfg.get("requirements"))
        tools[name] = ToolSpec(
            name=name, command=tcfg.get("command"), inputs=inputs,
            outputs=outputs, requirements=req, est_output_bytes=est,
            implementation=tcfg.get("implementation"))
    return tools


# ---------------------------------------------------------------------------
# Command templates
# ---------------------------------------------------------------------------

def command_placeholders(template: str) -> List[str]:
    """Field names a command template references (``{shard}`` -> shard).
    Attribute/index suffixes resolve to their base name; positional
    fields come back as '' (always invalid)."""
    out: List[str] = []
    try:
        parsed = list(string.Formatter().parse(template))
    except ValueError:
        return [""]                  # unbalanced braces: flag the template
    for _, fieldname, _, _ in parsed:
        if fieldname is None:
            continue
        base = fieldname.split(".", 1)[0].split("[", 1)[0]
        out.append(base)
    return out


class _Defaulting(dict):
    def __missing__(self, key):      # tolerate runtime-only context keys
        return f"{{{key}}}"


def render_command(template: str, values: Dict[str, Any],
                   tag: Tuple[int, ...]) -> str:
    """Best-effort substitution of a command template for a dry-run /
    stub invocation record; never raises."""
    fmt: Dict[str, Any] = {}
    for k, v in values.items():
        fmt[k] = v if isinstance(v, (str, int, float, bool)) \
            else f"<{type(v).__name__}>"
    fmt.setdefault("tag", ".".join(str(i) for i in tag))
    try:
        return template.format_map(_Defaulting(fmt))
    except Exception:
        return template


# ---------------------------------------------------------------------------
# Tool-level checks (run once per document by the checker pass)
# ---------------------------------------------------------------------------

def check_tools(tools: Dict[str, ToolSpec], report: Report):
    """Per-tool validity: type expressions parse (SF106) and command
    placeholders name declared inputs (SF105)."""
    for name, tool in tools.items():
        tloc = f"tools.{name}"
        for iname, inp in tool.inputs.items():
            if parse_type(inp.type) is None:
                report("SF106", f"{tloc}.inputs.{iname}",
                       f"tool {name!r}: input {iname!r} has invalid type "
                       f"expression {inp.type!r}")
        for oname, texpr in tool.outputs.items():
            if parse_type(texpr) is None:
                report("SF106", f"{tloc}.outputs.{oname}",
                       f"tool {name!r}: output {oname!r} has invalid type "
                       f"expression {texpr!r}")
        if tool.command is not None:
            known = set(tool.inputs) | {"tag"}
            for ref in command_placeholders(tool.command):
                if ref not in known:
                    report("SF105", f"{tloc}.command",
                           f"tool {name!r}: command references "
                           f"{('{' + ref + '}') if ref else 'a positional {}'}"
                           f" but declares no such input "
                           f"(have {sorted(tool.inputs)})")


# ---------------------------------------------------------------------------
# Step fns
# ---------------------------------------------------------------------------

def _resolve_implementation(tool: ToolSpec, step_args: Optional[dict],
                            loc: str, report: Report
                            ) -> Optional[Callable]:
    """Import and construct a tool's Python implementation (a factory
    returning an ``(inputs, ctx) -> outputs`` callable), reporting SF108
    on any failure.  Resolution happens at compile time — exactly when a
    Python builder would have failed — not on site 7 mid-run."""
    impl = tool.implementation
    if impl is None:
        if step_args:
            report("SF108", loc,
                   f"step passes args {sorted(step_args)} but tool "
                   f"{tool.name!r} declares no implementation")
        return None
    args = {**(impl.get("args") or {}), **(step_args or {})}
    factory_name = impl.get("factory", "build_tool")
    try:
        mod = importlib.import_module(impl["module"])
        factory = getattr(mod, factory_name)
        fn = factory(**args)
    except Exception as e:
        report("SF108", loc,
               f"tool {tool.name!r} implementation "
               f"{impl.get('module')}:{factory_name} failed to resolve: "
               f"{type(e).__name__}: {e}")
        return None
    if not callable(fn):
        report("SF108", loc,
               f"tool {tool.name!r} implementation factory "
               f"{impl.get('module')}:{factory_name} returned "
               f"non-callable {type(fn).__name__}")
        return None
    return fn


def _make_step_fn(tool: ToolSpec, path: str, out_map: Dict[str, str],
                  streams: Dict[str, int],
                  inner: Optional[Callable]) -> Callable:
    """The runtime callable for a declarative step.

    With an implementation, delegates to it and remaps its output names
    to port names.  Without one, the step is a *command stub*: it emits
    one structured invocation record per output port (the rendered
    command template, tool, step, tag) — enough for dry-runs, plan
    benchmarks and downstream steps that only route data.
    """
    defaults = {n: i.default for n, i in tool.inputs.items()
                if i.has_default}

    def fn(inputs: Dict[str, Any], ctx) -> Dict[str, Any]:
        merged = {**defaults, **inputs}
        tag = tuple((ctx or {}).get("tag", ()))
        if inner is not None:
            raw = inner(merged, ctx) or {}
            out: Dict[str, Any] = {}
            for oname, port in out_map.items():
                source = oname if oname in raw else port
                if source not in raw:
                    raise RuntimeError(
                        f"{path}: tool {tool.name!r} implementation "
                        f"produced no value for output {oname!r} "
                        f"(got {sorted(raw)})")
                out[port] = raw[source]
            return out
        command = (render_command(tool.command, merged, tag)
                   if tool.command is not None else None)
        out = {}
        for oname, port in out_map.items():
            record = {"tool": tool.name, "step": path, "output": oname,
                      "tag": list(tag)}
            if command is not None:
                record["command"] = command
            width = streams.get(port)
            out[port] = (record if width is None else
                         [{**record, "element": i} for i in range(width)])
        return out

    return fn


# ---------------------------------------------------------------------------
# Workflow compilation
# ---------------------------------------------------------------------------

def _parse_declared_inputs(raw: Any, loc: str,
                           report: Report) -> Dict[str, str]:
    if raw is None:
        return {}
    if isinstance(raw, list):
        return {str(p): "any" for p in raw}
    out = {}
    for port, texpr in raw.items():
        texpr = texpr if isinstance(texpr, str) else "any"
        if parse_type(texpr) is None:
            report("SF106", f"{loc}.inputs.{port}",
                   f"workflow input {port!r} has invalid type expression "
                   f"{texpr!r}")
            texpr = "any"
        out[str(port)] = texpr
    return out


def compile_declarative(name: str, wcfg: dict,
                        tools: Dict[str, ToolSpec],
                        collect: Optional[Report] = None) -> Workflow:
    """Compile a ``type: declarative`` workflow entry into a Workflow.

    ``collect(code, location, message)`` switches from raise-on-first
    (the lazy path) to collect-and-recover (the checker path); recovered
    skeletons drop only the offending declaration, keeping the rest of
    the graph checkable.  The compiled workflow carries three frontend
    annotations the checker consumes: ``declared_inputs`` (port -> type
    of the ``inputs:`` block), ``port_types`` and ``slot_types``.
    """
    strict = collect is None

    def report(code: str, location: str, message: str):
        if strict:
            raise StreamFlowFileError(f"[{code}] {location}: {message}")
        collect(code, location, message)

    loc = f"workflows.{name}"
    wf = Workflow(name)
    declared_inputs = _parse_declared_inputs(wcfg.get("inputs"), loc, report)
    port_types: Dict[str, str] = dict(declared_inputs)
    slot_types: Dict[Tuple[str, str], str] = {}
    produced: Dict[str, str] = {}    # port -> producing step path

    for path, decl in (wcfg.get("steps") or {}).items():
        decl = decl or {}
        sloc = f"{loc}.steps.{path}"
        if not (isinstance(path, str) and path.startswith("/")
                and path != "/" and INVOCATION_SEP not in path
                and posixpath.normpath(path) == path):
            report("SF140", sloc,
                   f"invalid step path {path!r}: must be an absolute, "
                   f"normalised POSIX path (not '/', no "
                   f"{INVOCATION_SEP!r})")
            continue

        tool = tools.get(decl.get("tool"))
        known_tool = tool is not None
        if not known_tool:
            report("SF101", sloc,
                   f"step {path}: unknown tool {decl.get('tool')!r} "
                   f"(declared tools: {sorted(tools)})")
            tool = ToolSpec(name=str(decl.get("tool")))

        in_map: Dict[str, str] = dict(decl.get("in") or {})
        out_map: Dict[str, str] = dict(decl.get("out") or {})
        if known_tool:
            for slot in sorted(set(in_map) - set(tool.inputs)):
                report("SF102", sloc,
                       f"step {path}: tool {tool.name!r} declares no "
                       f"input {slot!r} (have {sorted(tool.inputs)})")
                in_map.pop(slot)
            for slot in tool.required_inputs:
                if slot not in in_map:
                    report("SF103", sloc,
                           f"step {path}: tool {tool.name!r} input "
                           f"{slot!r} is required but not wired in")
            for oname in sorted(set(out_map) - set(tool.outputs)):
                report("SF104", sloc,
                       f"step {path}: tool {tool.name!r} declares no "
                       f"output {oname!r} (have {sorted(tool.outputs)})")
                out_map.pop(oname)
            for oname in tool.outputs:
                out_map.setdefault(oname, oname)

        # scatter/gather declarations must name wired slots
        scatter = list(dict.fromkeys(decl.get("scatter") or []))
        gather = list(dict.fromkeys(decl.get("gather") or []))
        for slot in [s for s in scatter + gather if s not in in_map]:
            report("SF221", sloc,
                   f"step {path}: scatter/gather slot {slot!r} is not a "
                   f"wired input (have {sorted(in_map)})")
        scatter = [s for s in scatter if s in in_map]
        gather = [s for s in gather if s in in_map]
        overlap = sorted(set(scatter) & set(gather))
        if overlap:
            report("SF134", sloc,
                   f"step {path}: slots {overlap} cannot both scatter "
                   f"and gather")
            gather = [g for g in gather if g not in overlap]

        # output ports: collisions within the step or across steps
        for oname in sorted(out_map):
            port = out_map[oname]
            owner = produced.get(port)
            if owner == path:
                report("SF110", f"{sloc}.out",
                       f"step {path}: two outputs map to the same port "
                       f"{port!r}")
                out_map.pop(oname)
                continue
            if owner is not None:
                report("SF110", sloc,
                       f"port {port!r} produced by both {owner} and {path}")
                out_map.pop(oname)
                continue
            produced[port] = path
            if known_tool:
                port_types.setdefault(port, tool.outputs.get(oname, "any"))
        out_ports = list(dict.fromkeys(out_map.values()))

        streams: Dict[str, int] = {}
        for port, width in (decl.get("streams") or {}).items():
            if port not in out_ports:
                report("SF135", sloc,
                       f"step {path}: stream {port!r} is not an output "
                       f"port of this step (have {out_ports})")
            elif not isinstance(width, int) or isinstance(width, bool) \
                    or width < 0:
                report("SF135", sloc,
                       f"step {path}: stream {port!r} width must be a "
                       f"non-negative int, got {width!r}")
            else:
                streams[port] = width

        req, est = ((tool.requirements, tool.est_output_bytes)
                    if "requirements" not in decl
                    else _parse_requirements(decl.get("requirements")))
        inner = _resolve_implementation(tool, decl.get("args"), sloc,
                                        report) if known_tool else None
        fn = _make_step_fn(tool, path, dict(out_map), streams, inner)
        wf.add_step(Step(path=path, fn=fn, inputs=in_map,
                         outputs=tuple(out_ports), requirements=req,
                         est_output_bytes=est, scatter=tuple(scatter),
                         gather=tuple(gather), streams=streams))
        if known_tool:
            for slot in in_map:
                if slot in tool.inputs:
                    slot_types[(path, slot)] = tool.inputs[slot].type

    # frontend annotations the checker keys on (see check_graph)
    wf.declared_inputs = declared_inputs
    wf.port_types = port_types
    wf.slot_types = slot_types
    if strict:
        wf.validate()
    return wf


def rebuild_declarative(name: str, workflow: dict,
                        tools: Optional[dict] = None) -> Workflow:
    """Journal-resume builder: ``JournalState.build_workflow`` records
    {module: repro_torch.core.frontend, builder: rebuild_declarative, args:
    {name, workflow, tools}} for declarative workflows, so a resume
    recompiles the same graph from the same (JSON-serialisable)
    document fragments."""
    return compile_declarative(name, workflow, parse_tools(tools))
