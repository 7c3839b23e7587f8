"""Workflow model: Steps joined by Ports that carry streams of Tokens.

Mirrors production StreamFlow's object model (and the paper's §4.3 file
semantics): every step has a POSIX-like path id ("/split",
"/chains/2/count", ...); sub-workflows are folders; bindings resolve by
deepest-matching path.  Data dependencies flow through **Ports**: a Port
connects one producer step to any number of consumer *slots* and carries
an ordered stream of **Tokens** (value reference + scatter tag +
cardinality).  The paper's flat single-assignment token strings are the
degenerate case — a scalar Port carries exactly one untagged Token whose
reference *is* the port name, which is why pre-Port builders keep working
unchanged.

Scatter/gather (the CWL idiom StreamFlow executes) are first-class:

* ``Step.streams = {"shard": N}`` — the step emits N element tokens
  ``shard[0] .. shard[N-1]`` on one port (its fn returns a list);
* ``Step.scatter = ("shard",)`` — the step runs once **per element** of
  the port bound to that slot: one declared step expands into N
  placeable *invocations*, each independently schedulable, routable and
  journal-recoverable.  Multiple scattered slots zip by tag;
* ``Step.gather = ("labels",)`` — the step fires once, after *every*
  element arrived, and its fn receives the whole stream as a list.

``Workflow.expand()`` turns the declared graph into an
:class:`InvocationPlan` — the flat, per-invocation DAG the executor
actually drives.  Invocations duck-type Steps (``inputs`` maps slots to
token refs, ``outputs`` lists token refs, ``fn`` adapts gather/stream
marshalling), so every path-keyed, token-keyed mechanism downstream
(scheduler, data plane, journal) works per invocation for free.

A step's ``fn`` is the 2026 re-grounding of the paper's container
command: a Python callable — usually wrapping a PyTorch computation —
executed on a *resource* (mesh-slice replica / host executor) by a
Connector.  Scattered fns read their coordinates from ``ctx["tag"]``.
"""
from __future__ import annotations

import posixpath
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

#: Separator between a step path and its scatter tag in invocation paths
#: ("/count@3"); never appears in valid step paths (they are normalised
#: POSIX paths) so the mapping back to the declared step is unambiguous.
INVOCATION_SEP = "@"


# ---------------------------------------------------------------------------
# Tokens: the unit of data flowing through a port
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Token:
    """One value in a port's stream.

    ``ref`` is the wire format — the key used in object stores, the
    transfer log and the execution journal — so the whole data plane
    stays string-keyed while the workflow layer reasons structurally.
    A scalar token's ref is the bare port name (the paper's flat token
    string); element tokens append their tag: ``shard[3]``, and nested
    scatters dot-join coordinates: ``shard[1.2]``.
    """
    port: str
    tag: Tuple[int, ...] = ()
    cardinality: int = 1            # width of the scatter group it belongs to

    @property
    def ref(self) -> str:
        return token_ref(self.port, self.tag)


def token_ref(port: str, tag: Tuple[int, ...] = ()) -> str:
    """The store/journal key for a port element (see :class:`Token`)."""
    if not tag:
        return port
    return f"{port}[{'.'.join(str(i) for i in tag)}]"


def parse_token_ref(ref: str) -> Tuple[str, Tuple[int, ...]]:
    """Inverse of :func:`token_ref`; unparseable refs are scalar."""
    if ref.endswith("]"):
        base, bracket, inner = ref.rpartition("[")
        if bracket:
            try:
                return base, tuple(int(x) for x in inner[:-1].split("."))
            except ValueError:
                pass
    return ref, ()


def invocation_base(path: str) -> str:
    """Declared step path behind an invocation path ("/count@3" -> "/count").
    Binding resolution and scatter-group accounting key on this."""
    return path.split(INVOCATION_SEP, 1)[0]


# ---------------------------------------------------------------------------
# Ports and Steps: the declared graph
# ---------------------------------------------------------------------------

@dataclass
class Port:
    """A named edge from one producer step to its consumer slots."""
    name: str
    producer: Optional[str] = None                # step path; None = wf input
    consumers: List[Tuple[str, str]] = field(default_factory=list)
    #                                             # (step path, input slot)


@dataclass(frozen=True)
class Requirements:
    """Minimum hardware asks, checked against resource capabilities."""
    cores: int = 1
    memory_gb: float = 1.0


@dataclass
class Step:
    path: str                                   # POSIX id, unique in workflow
    fn: Callable[..., Dict[str, Any]]           # (inputs, ctx) -> outputs
    inputs: Dict[str, str] = field(default_factory=dict)   # slot -> port
    outputs: Tuple[str, ...] = ()               # port names produced
    requirements: Requirements = Requirements()
    # Expected relative output size (bytes) — lets the locality policy reason
    # about placement before the data exists (the paper's known file sizes).
    est_output_bytes: int = 0
    # -- scatter/gather declarations (see module docstring) -----------------
    scatter: Tuple[str, ...] = ()               # slots consumed element-wise
    gather: Tuple[str, ...] = ()                # slots collecting a stream
    streams: Dict[str, int] = field(default_factory=dict)  # port -> width

    def __post_init__(self):
        if not self.path.startswith("/"):
            raise ValueError(f"step path must be absolute: {self.path!r}")
        norm = posixpath.normpath(self.path)
        if norm != self.path:
            raise ValueError(f"non-normalised step path: {self.path!r}")
        if INVOCATION_SEP in self.path:
            raise ValueError(f"step path may not contain "
                             f"{INVOCATION_SEP!r}: {self.path!r}")
        self.scatter = tuple(self.scatter)
        self.gather = tuple(self.gather)
        for slot in (*self.scatter, *self.gather):
            if slot not in self.inputs:
                raise ValueError(f"{self.path}: scatter/gather slot "
                                 f"{slot!r} is not an input slot")
        if set(self.scatter) & set(self.gather):
            raise ValueError(f"{self.path}: slots "
                             f"{sorted(set(self.scatter) & set(self.gather))}"
                             f" cannot both scatter and gather")
        for port, width in self.streams.items():
            if port not in self.outputs:
                raise ValueError(f"{self.path}: stream {port!r} is not an "
                                 f"output port")
            if not isinstance(width, int) or isinstance(width, bool) \
                    or width < 0:
                raise ValueError(f"{self.path}: stream {port!r} width must "
                                 f"be a positive int or 0, got {width!r}")


class Workflow:
    """A DAG of steps keyed by POSIX path, joined by named Ports."""

    def __init__(self, name: str):
        self.name = name
        self.steps: Dict[str, Step] = {}
        self.ports: Dict[str, Port] = {}
        self._producer: Dict[str, str] = {}      # port -> step path
        # {module, builder, args} when built from a StreamFlow file — lets
        # the execution journal record how to rebuild this DAG on resume
        self.builder_info: Optional[Dict[str, Any]] = None

    def add_step(self, step: Step) -> Step:
        if step.path in self.steps:
            raise ValueError(f"duplicate step path {step.path}")
        for port_name in step.outputs:
            if port_name in self._producer:
                raise ValueError(
                    f"token {port_name!r} produced by both "
                    f"{self._producer[port_name]} and {step.path}")
            self._producer[port_name] = step.path
            port = self.ports.setdefault(port_name, Port(port_name))
            port.producer = step.path
        for slot, port_name in step.inputs.items():
            port = self.ports.setdefault(port_name, Port(port_name))
            port.consumers.append((step.path, slot))
        self.steps[step.path] = step
        return step

    def producer_of(self, token: str) -> Optional[str]:
        return self._producer.get(token)

    def predecessors(self, path: str) -> List[str]:
        out = []
        for tok in self.steps[path].inputs.values():
            p = self._producer.get(tok)
            if p is not None and p not in out:
                out.append(p)
        return out

    def successors(self, path: str) -> List[str]:
        mine = set(self.steps[path].outputs)
        return [s.path for s in self.steps.values()
                if mine & set(s.inputs.values())]

    # -- validation ---------------------------------------------------------

    def find_cycle(self) -> Optional[List[str]]:
        """First dependency cycle found, as the step-path trail that closes
        it (``[.., a, b, a]``), or None for a DAG.

        Iterative (explicit stack): scatter produces graphs ~1k deep/wide,
        far past CPython's default recursion limit.  The static checker
        calls this directly to report cycles as diagnostics instead of
        exceptions; :meth:`validate` raises on the same trail.
        """
        state: Dict[str, int] = {}               # 1 = on stack, 2 = done
        for root in self.steps:
            if state.get(root) == 2:
                continue
            state[root] = 1
            trail = [root]
            stack = [(root, iter(self.predecessors(root)))]
            while stack:
                path, preds = stack[-1]
                advanced = False
                for q in preds:
                    mark = state.get(q)
                    if mark == 2:
                        continue
                    if mark == 1:
                        return trail + [q]
                    state[q] = 1
                    trail.append(q)
                    stack.append((q, iter(self.predecessors(q))))
                    advanced = True
                    break
                if not advanced:
                    state[path] = 2
                    stack.pop()
                    trail.pop()
        return None

    def validate(self):
        """Raises on cycles (see :meth:`find_cycle`)."""
        trail = self.find_cycle()
        if trail is not None:
            raise ValueError(
                f"cycle through {trail[-1]}: {' -> '.join(trail)}")

    def external_inputs(self) -> List[str]:
        """Ports consumed but produced by no step (workflow arguments)."""
        need = {t for s in self.steps.values() for t in s.inputs.values()}
        return sorted(need - set(self._producer))

    def final_outputs(self) -> List[str]:
        """Ports produced but consumed by no step (workflow results)."""
        used = {t for s in self.steps.values() for t in s.inputs.values()}
        return sorted(set(self._producer) - used)

    def fireable(self, done_tokens: Sequence[str],
                 started: Sequence[str]) -> List[str]:
        """FCFS-ordered steps whose inputs are all available (paper §4.4).

        Step-level view (scatter-blind) — kept for the Python API and the
        pre-Port callers; the executor fires :class:`InvocationPlan`
        entries instead.
        """
        have = set(done_tokens)
        busy = set(started)
        out = []
        for path, step in self.steps.items():
            if path in busy:
                continue
            if all(t in have for t in step.inputs.values()):
                out.append(path)
        return out

    # -- expansion ----------------------------------------------------------

    def _topo_order(self) -> List[str]:
        """Producers before consumers (iterative Kahn)."""
        indeg = {p: 0 for p in self.steps}
        succs: Dict[str, List[str]] = {p: [] for p in self.steps}
        for path, step in self.steps.items():
            for port_name in step.inputs.values():
                prod = self._producer.get(port_name)
                if prod is not None and prod != path:
                    indeg[path] += 1
                    succs[prod].append(path)
        ready = [p for p, d in indeg.items() if d == 0]
        order: List[str] = []
        while ready:
            p = ready.pop(0)
            order.append(p)
            for q in succs[p]:
                indeg[q] -= 1
                if indeg[q] == 0:
                    ready.append(q)
        if len(order) != len(self.steps):
            raise ValueError("cycle in workflow (expand)")
        return order

    def stream_geometry(self, on_error: Optional[
            Callable[[str, str, str], None]] = None
            ) -> Tuple[Dict[str, List[Tuple[int, ...]]],
                       Dict[str, List[Tuple[int, ...]]]]:
        """Resolve every port's stream geometry without materialising
        invocations: ``(port_tags, step_tags)`` where ``port_tags`` maps
        each *stream* port to its ordered element tags (scalar ports are
        absent) and ``step_tags`` maps each step to the tags it fires at
        (``[()]`` for a scalar step).

        This is the single source of truth for scatter/gather coherence,
        shared by :meth:`expand` and the static checker.  A malformed
        declaration calls ``on_error(kind, step_path, message)`` with
        ``kind`` one of ``scatter-scalar``, ``gather-scalar``,
        ``stream-undeclared``, ``zip-width``; the default raises
        ValueError (expand's historical behaviour), while a collecting
        hook records the problem, after which geometry recovers with the
        scalar interpretation so downstream steps still get resolved.
        """
        if on_error is None:
            def on_error(kind: str, path: str, message: str):
                raise ValueError(message)
        order = self._topo_order()
        # port -> ordered element tags; scalar ports are absent
        port_tags: Dict[str, List[Tuple[int, ...]]] = {}
        step_tags: Dict[str, List[Tuple[int, ...]]] = {}

        for path in order:
            step = self.steps[path]
            for slot, port_name in step.inputs.items():
                is_stream = port_name in port_tags
                if slot in step.scatter or slot in step.gather:
                    if not is_stream:
                        on_error(
                            "scatter-scalar" if slot in step.scatter
                            else "gather-scalar", path,
                            f"{path}: slot {slot!r} declares "
                            f"{'scatter' if slot in step.scatter else 'gather'}"
                            f" but port {port_name!r} is scalar")
                elif is_stream:
                    on_error(
                        "stream-undeclared", path,
                        f"{path}: slot {slot!r} consumes stream port "
                        f"{port_name!r} — declare it in scatter (one "
                        f"invocation per element) or gather (collect the "
                        f"whole stream)")
            # recovery path only: a scattered slot whose port turned out
            # scalar is dropped from the zip set (on_error already fired)
            active = [s for s in step.scatter
                      if step.inputs[s] in port_tags]
            if active:
                tag_sets = [port_tags[step.inputs[s]] for s in active]
                first = tag_sets[0]
                for slot, tags in zip(active[1:], tag_sets[1:]):
                    if tags != first:
                        on_error(
                            "zip-width", path,
                            f"{path}: scattered slots zip by tag, but "
                            f"{active[0]!r} and {slot!r} carry "
                            f"different streams ({len(first)} vs "
                            f"{len(tags)} elements)")
                tags = list(first)
            else:
                tags = [()]
            step_tags[path] = tags
            for port_name in step.outputs:
                width = step.streams.get(port_name)
                if width is None:
                    if tags != [()]:
                        port_tags[port_name] = list(tags)
                    # else: scalar port, stays out of port_tags
                else:
                    port_tags[port_name] = [t + (i,) for t in tags
                                            for i in range(width)]
        return port_tags, step_tags

    def expand(self) -> "InvocationPlan":
        """Compile the declared graph into the per-invocation DAG.

        Resolves every port's stream geometry (which tags flow through
        it), checks the scatter/gather declarations are coherent, and
        materialises one :class:`Invocation` per (step, tag).  The
        expansion is deterministic — same workflow, same plan — which is
        what lets the execution journal resume a partially-completed
        scatter by invocation path.
        """
        self.validate()
        port_tags, step_tags = self.stream_geometry()
        order = self._topo_order()

        invocations: Dict[str, Invocation] = {}
        for path in order:
            step = self.steps[path]
            tags = step_tags[path]
            for tag in tags:
                ipath = (path if not tag else
                         path + INVOCATION_SEP
                         + ".".join(str(i) for i in tag))
                inputs: Dict[str, str] = {}
                gather_widths: Dict[str, int] = {}
                for slot, port_name in step.inputs.items():
                    if slot in step.scatter:
                        inputs[slot] = token_ref(port_name, tag)
                    elif slot in step.gather:
                        elems = port_tags[port_name]
                        gather_widths[slot] = len(elems)
                        for k, etag in enumerate(elems):
                            inputs[f"{slot}[{k}]"] = token_ref(port_name,
                                                               etag)
                    else:
                        inputs[slot] = port_name
                outputs: List[str] = []
                streams: Dict[str, List[str]] = {}
                for port_name in step.outputs:
                    width = step.streams.get(port_name)
                    if width is None:
                        outputs.append(token_ref(port_name, tag))
                    else:
                        refs = [token_ref(port_name, tag + (i,))
                                for i in range(width)]
                        streams[port_name] = refs
                        outputs.extend(refs)
                invocations[ipath] = Invocation(
                    step, ipath, tag, inputs, tuple(outputs),
                    gather_widths, streams, cardinality=len(tags))
        return InvocationPlan(self, invocations, port_tags, step_tags)


class Invocation:
    """One placeable unit of work: a (step, scatter-tag) pair.

    Duck-types :class:`Step` for the executor — ``inputs`` maps slot keys
    to token refs, ``outputs`` lists the token refs this invocation must
    produce, and ``fn`` wraps the step's fn with the gather/stream
    marshalling — so scheduling, transfers and journaling all work on
    invocations without knowing about scatter.
    """

    def __init__(self, step: Step, path: str, tag: Tuple[int, ...],
                 inputs: Dict[str, str], outputs: Tuple[str, ...],
                 gather_widths: Dict[str, int],
                 streams: Dict[str, List[str]], cardinality: int = 1):
        self.step = step
        self.path = path
        self.tag = tag
        self.inputs = inputs
        self.outputs = outputs
        self.cardinality = cardinality          # invocations in this group
        self._gather_widths = gather_widths
        self._streams = streams
        self.fn = self._call                     # Step-compatible attribute

    @property
    def requirements(self) -> Requirements:
        return self.step.requirements

    @property
    def est_output_bytes(self) -> int:
        return self.step.est_output_bytes

    def tokens(self) -> List[Token]:
        """Structured view of the refs this invocation produces."""
        out = []
        for ref in self.outputs:
            port, tag = parse_token_ref(ref)
            out.append(Token(port, tag, self.cardinality))
        return out

    def _call(self, inputs: Dict[str, Any], ctx) -> Dict[str, Any]:
        # reassemble gathered streams: flattened "slot[k]" keys -> one list
        clean: Dict[str, Any] = {}
        gathered = {slot: [None] * n
                    for slot, n in self._gather_widths.items()}
        for key, value in inputs.items():
            base, tag = parse_token_ref(key)
            if base in gathered and tag:
                gathered[base][tag[0]] = value
            else:
                clean[key] = value
        clean.update(gathered)
        ctx = dict(ctx or {})
        ctx["tag"] = self.tag
        ctx["invocation"] = self.path
        raw = self.step.fn(clean, ctx) or {}
        out: Dict[str, Any] = {}
        for port_name in self.step.outputs:
            if port_name not in raw:
                # pre-Port fns may already answer in refs (port == ref for
                # every scalar step, so this is only reachable on streams)
                raise RuntimeError(
                    f"{self.path} produced no value for port {port_name!r} "
                    f"(got {sorted(raw)})")
            value = raw[port_name]
            refs = self._streams.get(port_name)
            if refs is None:
                out[token_ref(port_name, self.tag)] = value
            else:
                if not isinstance(value, (list, tuple)) \
                        or len(value) != len(refs):
                    got = (len(value) if isinstance(value, (list, tuple))
                           else type(value).__name__)
                    raise RuntimeError(
                        f"{self.path}: stream port {port_name!r} declares "
                        f"{len(refs)} elements but fn returned {got}")
                out.update(zip(refs, value))
        return out


class InvocationPlan:
    """The expanded, per-invocation DAG the executor drives.

    Presents the same surface the executor used to consume on Workflow
    (``steps``, ``fireable``, ``successors``, ``external_inputs``,
    ``final_outputs``, ``validate``, ``name``, ``builder_info``), with
    every entry an :class:`Invocation` and every token a concrete ref.
    """

    def __init__(self, workflow: Workflow,
                 invocations: Dict[str, Invocation],
                 port_tags: Dict[str, List[Tuple[int, ...]]],
                 step_tags: Dict[str, List[Tuple[int, ...]]]):
        self.workflow = workflow
        self.name = workflow.name
        self.builder_info = workflow.builder_info
        self.steps: Dict[str, Invocation] = invocations
        self.port_tags = port_tags
        self._step_tags = step_tags
        self._producer: Dict[str, str] = {}
        self._consumers: Dict[str, List[str]] = {}
        for ipath, inv in invocations.items():
            for ref in inv.outputs:
                self._producer[ref] = ipath
            for ref in inv.inputs.values():
                self._consumers.setdefault(ref, []).append(ipath)

    def expand(self) -> "InvocationPlan":
        return self

    def validate(self):
        pass                                     # expand() already validated

    def producer_of(self, ref: str) -> Optional[str]:
        return self._producer.get(ref)

    def predecessors(self, path: str) -> List[str]:
        out: List[str] = []
        for ref in self.steps[path].inputs.values():
            p = self._producer.get(ref)
            if p is not None and p not in out:
                out.append(p)
        return out

    def successors(self, path: str) -> List[str]:
        out: List[str] = []
        for ref in self.steps[path].outputs:
            for q in self._consumers.get(ref, ()):
                if q not in out:
                    out.append(q)
        return out

    def external_inputs(self) -> List[str]:
        need = {r for inv in self.steps.values()
                for r in inv.inputs.values()}
        return sorted(need - set(self._producer))

    def final_outputs(self) -> List[str]:
        return sorted(set(self._producer) - set(self._consumers))

    def output_ports(self) -> Dict[str, List[str]]:
        """Final outputs grouped by port: port -> ordered element refs.
        Scalar ports map to the one ref (== the port name); stream ports
        list their elements in tag order, ready to collect into a list."""
        grouped: Dict[str, List[str]] = {}
        for ref in self.final_outputs():
            port, _tag = parse_token_ref(ref)
            grouped.setdefault(port, []).append(ref)
        out: Dict[str, List[str]] = {}
        for port in sorted(grouped):
            tags = self.port_tags.get(port)
            if tags is None:
                out[port] = [port]
            else:                                # journal/tag order
                out[port] = [token_ref(port, t) for t in tags]
        return out

    def scatter_widths(self) -> Dict[str, int]:
        """Declared step -> invocation count, for scattered steps only.
        A zero-width scatter appears with width 0 (the step fires no
        invocations — resume and the conformance corpus both need to see
        that, not mistake it for a scalar step)."""
        return {path: len(tags) for path, tags in self._step_tags.items()
                if len(tags) != 1}

    def summary(self) -> Dict[str, Any]:
        """Canonical JSON-serialisable view of the plan.

        Two workflows are *plan-identical* iff their summaries are equal —
        this is what the conformance corpus and `streamflow check` compare
        (invocation paths, token wiring, gather widths, requirements),
        deliberately excluding the fns themselves.
        """
        invocations = {}
        for ipath, inv in self.steps.items():
            invocations[ipath] = {
                "step": inv.step.path,
                "tag": list(inv.tag),
                "cardinality": inv.cardinality,
                "inputs": dict(inv.inputs),
                "outputs": list(inv.outputs),
                "gather": dict(inv._gather_widths),
                "requirements": {
                    "cores": inv.requirements.cores,
                    "memory_gb": inv.requirements.memory_gb,
                },
            }
        return {
            "invocations": invocations,
            "external_inputs": self.external_inputs(),
            "final_outputs": self.final_outputs(),
            "widths": self.scatter_widths(),
        }

    def fireable(self, done_tokens: Sequence[str],
                 started: Sequence[str]) -> List[str]:
        """FCFS-ordered invocations whose input tokens all exist."""
        have = set(done_tokens)
        busy = set(started)
        out = []
        for path, inv in self.steps.items():
            if path in busy:
                continue
            if all(r in have for r in inv.inputs.values()):
                out.append(path)
        return out


def match_binding(step_path: str, binding_paths: Sequence[str]
                  ) -> Optional[str]:
    """Deepest-matching binding path for a step (paper §4.3: a folder binding
    applies recursively unless a deeper entry overrides it).  Invocation
    paths resolve through their declared step (strip the tag first with
    :func:`invocation_base`)."""
    step_path = invocation_base(step_path)
    best: Optional[str] = None
    for b in binding_paths:
        norm = posixpath.normpath(b)
        if step_path == norm or step_path.startswith(
                norm.rstrip("/") + "/") or norm == "/":
            if best is None or len(norm) > len(best):
                best = norm
    return best
