"""StreamFlow-file loading (paper §4.3): one YAML entry point wiring
workflows to execution environments.

``config_schema.json`` next to this module is the authoritative format
description and is enforced here by a small dependency-free validator
(same role as the paper's JSON-Schema validation pass).  After the
schema pass, the static checker (``repro_torch.core.checker``) analyses the
compiled graphs, bindings and models and raises one
:class:`~repro_torch.core.checker.WorkflowCheckError` carrying *every*
diagnostic; ``check: off`` (or ``load(..., check=False)``) skips the
pass and preserves the historical lazy-failure behaviour, where the same
mistakes surface eagerly one at a time or mid-run.
"""
from __future__ import annotations

import importlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import checker as _checker
from repro_torch.core import frontend as _frontend
# historical home of this exception is here; checker defines it to avoid
# an import cycle (see its docstring)
from repro_torch.core.checker import StreamFlowFileError, WorkflowCheckError
from repro_torch.core.deployment import ModelSpec
from repro_torch.core.workflow import Workflow

_SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "config_schema.json")


@dataclass
class Binding:
    step: str
    model: str
    service: str
    # further (model, service) targets beyond the primary one: every target
    # may host this step's invocations, and the scheduler decides per
    # invocation — how one scatter spreads across sites
    extra_targets: Tuple[Tuple[str, str], ...] = ()

    @property
    def targets(self) -> List[Tuple[str, str]]:
        return [(self.model, self.service), *self.extra_targets]


@dataclass
class WorkflowEntry:
    name: str
    workflow: Workflow
    bindings: List[Binding]


@dataclass
class StreamFlowConfig:
    models: Dict[str, ModelSpec]
    workflows: Dict[str, WorkflowEntry]
    policy: str = "data_locality"
    grace_period_s: Optional[float] = None
    fault: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Dict[str, Any] = field(default_factory=dict)
    # the ``topology:`` block — inter-site links + routing mode; an empty
    # dict means the paper's management-node star (two-step only)
    topology: Dict[str, Any] = field(default_factory=dict)
    # the ``service:`` block — multi-tenant admission (max_concurrent,
    # per-tenant quotas/shares/priorities) and deployment-pool policy;
    # consumed by repro_torch.core.service.WorkflowService
    service: Dict[str, Any] = field(default_factory=dict)
    # the ``cache:`` block — cross-run invocation memoization + CAS
    # routing (enabled/index_path/scope).  Kept as the raw YAML value:
    # ``cache: off`` parses to False, absence to {}, both meaning
    # disabled (the engine's exact pre-cache behaviour);
    # persistence.CacheConfig.from_value normalizes downstream
    cache: Any = field(default_factory=dict)
    # parsed ``tools:`` block (declarative frontend) — kept for
    # introspection; workflows already compiled against it
    tools: Dict[str, Any] = field(default_factory=dict)
    # the ``autoscale:`` block — per-model replica envelopes, pressure
    # targets, cooldown, spot (``preemptible``) semantics.  Absent/empty
    # means no Autoscaler object at all: the exact static-pool behaviour
    autoscale: Dict[str, Any] = field(default_factory=dict)
    # the ``analyze:`` block — plan-time semantic analysis (SF3xx) gate
    # for WorkflowService.submit_document.  Raw YAML value: ``analyze:
    # off`` parses to False, absence to {}, both meaning the gate is off
    # and the engine behaves exactly as before the analyzer existed;
    # analyzer.AnalyzeConfig.from_value normalizes downstream
    analyze: Any = field(default_factory=dict)


def _check(cond: bool, msg: str):
    if not cond:
        raise StreamFlowFileError(msg)


def _validate_against_schema(doc: dict, schema: dict, path: str = "$"):
    """Minimal JSON-Schema subset validator (type/required/enum/properties/
    additionalProperties/items/minimum/minItems/pattern) — enough to
    enforce config_schema.json."""
    t = schema.get("type")
    if t:
        types = t if isinstance(t, list) else [t]
        pymap = {"object": dict, "array": list, "string": str,
                 "boolean": bool, "integer": int, "number": (int, float),
                 "null": type(None)}
        _check(any(isinstance(doc, pymap[x]) for x in types),
               f"{path}: expected {t}, got {type(doc).__name__}")
        if "boolean" not in types and isinstance(doc, bool) \
                and "integer" in types:
            raise StreamFlowFileError(f"{path}: bool where integer expected")
    if "enum" in schema:
        _check(doc in schema["enum"],
               f"{path}: {doc!r} not one of {schema['enum']}")
    if "minimum" in schema and isinstance(doc, (int, float)) \
            and not isinstance(doc, bool):
        _check(doc >= schema["minimum"],
               f"{path}: {doc} is below the minimum {schema['minimum']}")
    if "pattern" in schema and isinstance(doc, str):
        _check(re.search(schema["pattern"], doc) is not None,
               f"{path}: {doc!r} does not match pattern "
               f"{schema['pattern']!r}")
    if isinstance(doc, list) and "minItems" in schema:
        _check(len(doc) >= schema["minItems"],
               f"{path}: needs at least {schema['minItems']} item(s), "
               f"got {len(doc)}")
    if isinstance(doc, dict):
        # report the *full* JSON path of the offending key, not just the
        # enclosing object — nested failures under scatter:/targets: used
        # to name only the leaf object
        for req in schema.get("required", []):
            _check(req in doc,
                   f"{path}.{req}: missing required key {req!r}")
        props = schema.get("properties", {})
        addl = schema.get("additionalProperties", True)
        for k, v in doc.items():
            if k in props:
                _validate_against_schema(v, props[k], f"{path}.{k}")
            elif isinstance(addl, dict):
                _validate_against_schema(v, addl, f"{path}.{k}")
            elif addl is False:
                raise StreamFlowFileError(
                    f"{path}.{k}: unexpected key {k!r}")
    if isinstance(doc, list) and "items" in schema:
        for i, v in enumerate(doc):
            _validate_against_schema(v, schema["items"], f"{path}[{i}]")


def validate(doc: dict):
    with open(_SCHEMA_PATH) as f:
        schema = json.load(f)
    _validate_against_schema(doc, schema)


def _build_workflow(name: str, wcfg: dict) -> Workflow:
    mod = importlib.import_module(wcfg["module"])
    builder = getattr(mod, wcfg.get("builder", "build_workflow"))
    wf = builder(**wcfg.get("args", {}))
    _check(isinstance(wf, Workflow),
           f"workflow builder for {name} returned {type(wf).__name__}")
    wf.validate()
    # remember how to rebuild this DAG: the execution journal records it so
    # Executor.resume(journal_path) can reconstruct the workflow by itself
    wf.builder_info = {"module": wcfg["module"],
                       "builder": wcfg.get("builder", "build_workflow"),
                       "args": wcfg.get("args", {})}
    return wf


def _apply_scatter_block(name: str, wf: Workflow, entries: List[dict]):
    """Apply a workflow's ``scatter:`` block: each entry marks a step's
    input slots as scattered (``over`` — one invocation per stream
    element) or gathered (``gather`` — fire once with the whole stream).
    The block *augments* whatever the Python builder already declared, so
    plain builders become scatterable from configuration alone; the
    merged declarations are checked by re-expanding the workflow, so a
    typo'd slot or a scatter over a scalar port fails at load time, not
    mid-run."""
    for i, entry in enumerate(entries):
        step = wf.steps.get(entry["step"])
        _check(step is not None,
               f"workflow {name}: scatter[{i}] names unknown step "
               f"{entry['step']!r}")
        for key, attr in (("over", "scatter"), ("gather", "gather")):
            slots = entry.get(key, [])
            for slot in slots:
                _check(slot in step.inputs,
                       f"workflow {name}: scatter[{i}] ({step.path}): "
                       f"no input slot {slot!r} "
                       f"(have {sorted(step.inputs)})")
            if slots:
                merged = tuple(dict.fromkeys(
                    (*getattr(step, attr), *slots)))
                setattr(step, attr, merged)
        _check(not set(step.scatter) & set(step.gather),
               f"workflow {name}: scatter[{i}] ({step.path}): slots "
               f"{sorted(set(step.scatter) & set(step.gather))} cannot "
               f"both scatter and gather")
    if entries:
        try:
            wf.expand()
        except ValueError as e:
            raise StreamFlowFileError(
                f"workflow {name}: scatter block does not expand: {e}")


def _apply_scatter_block_collect(name: str, wf: Workflow,
                                 entries: List[dict], report):
    """Checker-mode twin of :func:`_apply_scatter_block`: every problem
    becomes a diagnostic (same messages), valid slots still merge, and
    the eager re-expand is skipped — ``checker.check_graph`` reports the
    merged geometry instead."""
    loc = f"workflows.{name}"
    for i, entry in enumerate(entries):
        eloc = f"{loc}.scatter[{i}]"
        step = wf.steps.get(entry["step"])
        if step is None:
            report("SF220", eloc,
                   f"workflow {name}: scatter[{i}] names unknown step "
                   f"{entry['step']!r}")
            continue
        for key, attr in (("over", "scatter"), ("gather", "gather")):
            good = []
            for slot in entry.get(key, []):
                if slot not in step.inputs:
                    report("SF221", eloc,
                           f"workflow {name}: scatter[{i}] ({step.path}): "
                           f"no input slot {slot!r} "
                           f"(have {sorted(step.inputs)})")
                else:
                    good.append(slot)
            if good:
                setattr(step, attr,
                        tuple(dict.fromkeys((*getattr(step, attr), *good))))
        overlap = sorted(set(step.scatter) & set(step.gather))
        if overlap:
            report("SF134", eloc,
                   f"workflow {name}: scatter[{i}] ({step.path}): slots "
                   f"{overlap} cannot both scatter and gather")
            step.gather = tuple(g for g in step.gather
                                if g not in overlap)


def _build_bindings_eager(models: Dict[str, ModelSpec],
                          raw: List[dict]) -> List[Binding]:
    """The historical (``check: off``) binding pass: raise on the first
    malformed entry or unknown model."""
    bindings = []
    for b in raw:
        _check("target" in b or "targets" in b,
               f"binding {b['step']}: needs a target (or targets)")
        _check(not ("target" in b and "targets" in b),
               f"binding {b['step']}: give target OR targets, "
               f"not both (ambiguous)")
        tgts = b.get("targets") or [b["target"]]
        for tgt in tgts:
            _check(tgt["model"] in models,
                   f"binding {b['step']}: unknown model {tgt['model']!r}")
        bindings.append(Binding(
            b["step"], tgts[0]["model"], tgts[0]["service"],
            tuple((t["model"], t["service"]) for t in tgts[1:])))
    return bindings


def _build_bindings_lenient(raw: List[dict]) -> List[Binding]:
    """Checker-mode binding construction: skip entries the checker
    already reported as malformed (load fails before they could be
    used), build the rest."""
    bindings = []
    for b in raw:
        if ("target" in b) == ("targets" in b):
            continue                             # SF200 reported
        tgts = b.get("targets") or [b["target"]]
        bindings.append(Binding(
            b["step"], tgts[0]["model"], tgts[0]["service"],
            tuple((t["model"], t["service"]) for t in tgts[1:])))
    return bindings


def check_enabled(doc: dict, override: Optional[bool] = None) -> bool:
    """Whether the static checker runs for this document: the
    ``load(check=...)`` override wins, then the document's ``check:``
    key (YAML ``off`` parses to False), defaulting to on."""
    if override is not None:
        return bool(override)
    return bool(doc.get("check", True))


def _yaml():
    """PyYAML, imported only for a path or a YAML string: a dict document
    loads without it."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "loading a StreamFlow file from a path or a YAML string needs "
            "PyYAML; a dict document loads without it") from e
    return yaml


def load(path_or_doc, *, check: Optional[bool] = None) -> StreamFlowConfig:
    """Load + validate a StreamFlow file (path, YAML string, or dict).

    With checking enabled (the default), every workflow — Python-built
    or declarative — passes through the static checker and *all*
    diagnostics are raised together as
    :class:`~repro_torch.core.checker.WorkflowCheckError`; with ``check: off``
    the loader keeps its historical eager/lazy failure behaviour.
    """
    if isinstance(path_or_doc, dict):
        doc = path_or_doc
    elif os.path.exists(str(path_or_doc)):
        with open(path_or_doc) as f:
            doc = _yaml().safe_load(f)
    else:
        doc = _yaml().safe_load(path_or_doc)
    validate(doc)
    checking = check_enabled(doc, check)
    collector = _checker.Collector()

    models = {name: ModelSpec(name, m["type"], m.get("config", {}),
                              m.get("external", False))
              for name, m in doc["models"].items()}

    tools = _frontend.parse_tools(doc.get("tools"))
    if checking:
        _frontend.check_tools(tools, collector)

    declared = doc.get("workflows") or {}
    if checking and not declared:
        # a document with nothing to run used to slip through as a silent
        # "OK: 0 workflow(s)" — make it a first-class diagnostic
        collector("SF150", "workflows",
                  "document declares no workflows (missing or empty "
                  "workflows: section) — nothing would run")

    workflows: Dict[str, WorkflowEntry] = {}
    for name, w in declared.items():
        wtype = w.get("type", "python")
        if wtype == "python":
            _check("config" in w,
                   f"workflow {name}: python workflows need a config block")
            wf = _build_workflow(name, w["config"])
        else:
            _check("steps" in w,
                   f"workflow {name}: declarative workflows need a "
                   f"steps block")
            wf = _frontend.compile_declarative(
                name, w, tools, collect=collector if checking else None)
            # journal-resume reference: recompile from the same document
            # fragments (JSON-serialisable, so the journal can record it)
            wf.builder_info = {
                "module": "repro_torch.core.frontend",
                "builder": "rebuild_declarative",
                "args": {"name": name,
                         "workflow": {k: w[k] for k in ("inputs", "steps")
                                      if k in w},
                         "tools": doc.get("tools") or {}}}
        entries = w.get("scatter", [])
        if checking:
            _apply_scatter_block_collect(name, wf, entries, collector)
        else:
            _apply_scatter_block(name, wf, entries)
        if entries:
            # the journaled builder reference must reproduce the
            # *scattered* workflow, or a journal-only resume would rebuild
            # the scalar plan and fail the structure check — record the
            # block so JournalState.build_workflow re-applies it
            wf.builder_info["scatter"] = entries
        if checking:
            _checker.check_bindings(name, wf, w["bindings"], models,
                                    collector)
            _checker.check_graph(wf, name, collector)
            bindings = _build_bindings_lenient(w["bindings"])
        else:
            bindings = _build_bindings_eager(models, w["bindings"])
        workflows[name] = WorkflowEntry(name, wf, bindings)

    ckpt = doc.get("checkpoint", {})
    if ckpt.get("enabled", True) and "journal_path" in ckpt:
        _check(bool(ckpt["journal_path"]),
               "checkpoint.journal_path must be non-empty")

    cache = doc.get("cache", {})
    if isinstance(cache, dict) and cache.get("enabled", True) \
            and "index_path" in cache:
        _check(bool(cache["index_path"]),
               "cache.index_path must be non-empty")

    autoscale = doc.get("autoscale", {})
    if checking and autoscale:
        _checker.check_autoscale(autoscale, models, collector)

    topology = doc.get("topology", {})
    for i, link in enumerate(topology.get("links", [])):
        for end in ("source", "target"):
            _check(link[end] in models,
                   f"topology.links[{i}].{end}: unknown model "
                   f"{link[end]!r}")
        _check(link["source"] != link["target"],
               f"topology.links[{i}]: source == target "
               f"({link['source']!r}); intra-model moves are always LAN")

    if checking and collector.diagnostics:
        raise WorkflowCheckError(collector.diagnostics)

    sched = doc.get("scheduling", {})
    return StreamFlowConfig(
        models=models, workflows=workflows,
        policy=sched.get("policy", "data_locality"),
        grace_period_s=sched.get("grace_period_s"),
        fault=doc.get("fault", {}),
        checkpoint=ckpt,
        topology=topology,
        service=doc.get("service", {}),
        cache=cache,
        tools=tools,
        autoscale=autoscale,
        analyze=doc.get("analyze", {}))
