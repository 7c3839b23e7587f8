"""The work of one step, counted as it runs: what ``repro/distributed/hlo.py``
gives the reference from its compiled HLO, the port counts at PyTorch's
dispatch (``FlopCounter``, a ``TorchDispatchMode``).

Over the ops that run under the mode it sums
  * FLOPs, by the formulas ``torch.utils.flop_counter`` registers (matrix
    products, convolutions, attention; elementwise ops count none);
  * bytes, each op's tensor inputs read and outputs written once (views
    move none; a factory reads nothing): the memory traffic of a program
    that keeps nothing on chip between ops;
  * the peak of the live bytes of the tensors the ops make (an estimate of
    the step's temporary memory: tensors made before the mode, such as the
    parameters, are not in it, and neither is a parameter's ``.grad``).

The four kernels count by their own work.  Each kernel wrapper records its
call (``recorded``) under the kernel's name with its package's
``cost.work`` (its backward with ``cost.bwd_work``), and while it records,
the ops inside it (the CUDA kernel's wrapper code, or the plain version
on the CPU) are not counted.  On the CPU and on ``meta`` the wrappers run
the call through ``counted_call``, so that its backward records too: a
kernel call counts the same on the card, on the CPU and on ``meta``, where
a wrapper returns empty outputs of the right shapes and computes nothing.

A Python loop of like iterations (the sLSTM's steps over time, the chunks
of the loss) is walked through ``loop(n)``.  Under a ``FlopCounter`` only
its first, second and last iterations run: the second's ops count n - 2
times, and so do their backward and the sums of the gradients it hands
on; the results are then not the model's, only its counts are, and they
equal the counts of every iteration run.

On a device mesh the step's tensors are DTensors.  The counter lets
DTensor turn each op into the ops on this rank's local pieces and the
collectives between ranks (``_c10d_functional``'s all-gather, all-reduce,
reduce-scatter and all-to-all, and the in-place all-reduce of
``torch.distributed.all_reduce``), and counts those: the FLOPs and bytes are
then one card's, and each collective adds its wire bytes per rank to
``collective_bytes`` (and its payload to the traffic) by the ring factors
of the reference's ``_wire``: an all-reduce of b bytes over g ranks sends
2 (g - 1) / g b, the others (g - 1) / g b, b the larger of its input and
output.  A collective over one rank, and every op on one card, moves
nothing between cards: ``collective_bytes`` stays empty there.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry


@dataclass
class KernelCount:
    flops: float = 0.0
    bytes: float = 0.0
    calls: int = 0


@dataclass
class FlopTotals:
    """The counts of one run under a ``FlopCounter`` (the port's
    ``HloTotals``): ``flops`` and ``traffic_bytes`` include the kernels'."""
    flops: float = 0.0
    traffic_bytes: float = 0.0
    kernels: Dict[str, KernelCount] = field(default_factory=dict)
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_calls: Dict[str, int] = field(default_factory=dict)
    peak_live_bytes: int = 0

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))


# ops whose inputs are not read: their output is filled without them
_FACTORY_LIKE = ("empty", "zeros_like", "ones_like", "full_like",
                 "rand_like", "randn_like", "new_zeros", "new_ones",
                 "new_full", "fill_", "zero_")


# ``_c10d_functional`` ops by the reference's collective names
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}


def _wire(kind: str, b: float, g: int) -> float:
    """Bytes one rank sends for a collective of ``b`` bytes over ``g``
    ranks (ring algorithms), as the reference's ``hlo._wire``."""
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * b
    return (g - 1) / g * b


def _collective(func, args, kwargs, out):
    """(kind, bytes, group size) of a functional collective or of an
    in-place all-reduce (``torch.distributed.all_reduce``), else None."""
    if func.namespace == "c10d" and func._opname == "allreduce_":
        import torch.distributed as dist
        return ("all-reduce", sum(t.nbytes for t in args[0]),
                dist.ProcessGroup.unbox(args[1]).size())
    if func.namespace != "_c10d_functional" or \
            func._opname not in _COLLECTIVES:
        return None
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = kwargs.get("group_name", args[-1])
    if not isinstance(group, dist.ProcessGroup):
        group = _resolve_process_group(group)
    tensors = [t for t in tree_leaves((args[0], out))
               if isinstance(t, torch.Tensor)]
    return (_COLLECTIVES[func._opname], max(t.nbytes for t in tensors),
            group.size())


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _propagating(types, args, kwargs) -> bool:
    """Whether the op is one DTensor runs to work out its placements (on
    fake tensors, or on meta tensors that carry a ``_spec``), not one of
    the step's own."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(issubclass(t, FakeTensor) for t in types) or any(
        hasattr(t, "_spec") for t in tree_leaves((args, kwargs))
        if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    return func is torch.ops.aten._unsafe_view.default or any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in func._schema.returns)


def _op_bytes(func, args, kwargs, out) -> int:
    if _is_view(func):
        return 0
    name = func.__name__
    if "empty" in name:
        return 0
    written = sum(t.nbytes for t in tree_leaves(out)
                  if isinstance(t, torch.Tensor))
    if any(f in name for f in _FACTORY_LIKE):
        return written
    read = sum(t.nbytes for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor))
    return read + written


class FlopCounter(TorchDispatchMode):
    """Counts FLOPs, bytes, kernel calls and live memory of the ops run
    under it (``with FlopCounter() as fc: step(...)``; then ``fc.totals``).
    """

    def __init__(self):
        super().__init__()
        self.totals = FlopTotals()
        self._suspended = 0
        self._scales: List[int] = []
        self._captures: List[List[torch.Tensor]] = []
        self._first_node: List[int] = []
        self._node_mult = (-1, 1)            # (backward task, scale)
        self._storages: Dict[int, List[int]] = {}   # key: [refs, bytes]
        self._excluded: set = set()
        self._live = 0

    # -- counting ---------------------------------------------------------
    @property
    def _mult(self) -> int:
        """The times the running op counts: the product of the enclosing
        loops' scales, and in a backward, the scale of the node that ran
        last (the engine sums its gradients after it)."""
        task, m = self._node_mult
        if task != _graph_task() or task == -1:
            m = 1
        for n in self._scales:
            m *= n
        return m

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(types):
            # DTensor runs the op as local ops and collectives, which come
            # back here
            return NotImplemented
        if _propagating(types, args, kwargs):
            return func(*args, **kwargs)
        if func.namespace == "aten" and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # an op that reaches the mode whole (as matmul does under
            # inference_mode) counts by the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self._track(func, out)
        if self._captures:
            self._captures[-1].extend(t for t in tree_leaves(out)
                                      if isinstance(t, torch.Tensor))
        if self._suspended:
            return out
        mult = self._mult
        coll = _collective(func, args, kwargs, out)
        if coll is not None:
            kind, nbytes, g = coll
            if g > 1:
                t = self.totals
                t.collective_bytes[kind] = t.collective_bytes.get(
                    kind, 0.0) + mult * _wire(kind, nbytes, g)
                t.collective_calls[kind] = t.collective_calls.get(
                    kind, 0) + mult
                t.traffic_bytes += mult * nbytes
            return out
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.totals.flops += mult * count(*args, **kwargs, out_val=out)
        self.totals.traffic_bytes += mult * _op_bytes(func, args, kwargs, out)
        return out

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        """One call of kernel ``name`` doing ``flops`` and moving
        ``nbytes`` (times the enclosing loops' trip counts)."""
        mult = self._mult
        k = self.totals.kernels.setdefault(name, KernelCount())
        k.flops += mult * flops
        k.bytes += mult * nbytes
        k.calls += mult
        self.totals.flops += mult * flops
        self.totals.traffic_bytes += mult * nbytes

    @contextlib.contextmanager
    def suspended(self):
        """Ops inside are not counted (a kernel call counts by its work)."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    # -- live memory --------------------------------------------------------
    def _track(self, func, out) -> None:
        # a view's or an in-place op's output holds its input's storage
        aliasing = func is torch.ops.aten._unsafe_view.default or any(
            r.alias_info is not None for r in func._schema.returns)
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage()._cdata
            if key in self._excluded:
                continue
            entry = self._storages.get(key)
            if entry is None:
                if aliasing:        # of a tensor made before the mode
                    continue
                nbytes = t.untyped_storage().nbytes()
                entry = self._storages[key] = [0, nbytes]
                self._live += nbytes
                self.totals.peak_live_bytes = max(
                    self.totals.peak_live_bytes, self._live)
            entry[0] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self._live -= entry[1]
            del self._storages[key]

    def exclude(self, t: torch.Tensor) -> None:
        """Take ``t``'s storage out of the live bytes from now on (a
        parameter's gradient, which the step's arguments already hold)."""
        key = t.untyped_storage()._cdata
        self._excluded.add(key)
        entry = self._storages.pop(key, None)
        if entry is not None:
            self._live -= entry[1]

    # -- loops ----------------------------------------------------------
    def _begin_iteration(self, scale: int) -> None:
        self._scales.append(scale)
        self._captures.append([])
        self._first_node.append(_next_node_number())

    def _end_iteration(self, loop_first) -> None:
        """Hook the autograd nodes this iteration made: their backward,
        and the engine's sums of the gradients they hand on, count as many
        times as their forward did.  The nodes the loop's nodes hand
        gradients to from before the loop get hooks that count once."""
        mult = self._mult
        self._scales.pop()
        outer = self._mult
        outs = self._captures.pop()
        first = self._first_node.pop()
        if first is None:           # no graph under no_grad
            return
        nodes = {}
        for t in outs:
            for fn in (t.grad_fn, t._base.grad_fn if t._base is not None
                       else None):
                if fn is not None and fn._sequence_nr() >= first:
                    nodes[id(fn)] = fn
        before = {}
        for fn in nodes.values():
            self._hook(fn, mult)
            for nxt, _ in fn.next_functions:
                if nxt is not None and id(nxt) not in nodes and \
                        "AccumulateGrad" not in nxt.name() and \
                        nxt._sequence_nr() < loop_first:
                    before[id(nxt)] = nxt
        for fn in before.values():
            self._hook(fn, outer)

    def _hook(self, fn, mult: int) -> None:
        def enter(grads):
            self._node_mult = (_graph_task(), mult)
        fn.register_prehook(enter)


def _next_node_number():
    """The sequence number the next autograd node of this thread gets, or
    None where no node is made (under ``no_grad`` or ``inference_mode``)."""
    if not torch.is_grad_enabled():
        return None
    for mode in _counters():
        mode._suspended += 1
    try:
        probe = torch.zeros((), requires_grad=True).clone()
        return probe.grad_fn._sequence_nr()
    finally:
        for mode in _counters():
            mode._suspended -= 1


def _graph_task() -> int:
    """The running backward's id, -1 outside a backward."""
    return torch._C._current_graph_task_id()


def _counters() -> List[FlopCounter]:
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, FlopCounter)]


def counting() -> bool:
    """Whether a ``FlopCounter`` is active."""
    return bool(_counters())


def loop(n: int):
    """``range(n)`` for a Python loop of ``n`` like iterations.  Under a
    ``FlopCounter``, and for n > 3, only iterations 0, 1 and n - 1 run:
    the first and the last count once (they may differ from the rest: a
    carry that needs no gradient comes in, one read from outside goes
    out), iteration 1 counts n - 2 times, and so does its backward."""
    modes = _counters()
    if not modes or n <= 3:
        yield from range(n)
        return
    first = _next_node_number()
    for t, scale in ((0, 1), (1, n - 2), (n - 1, 1)):
        for m in modes:
            m._begin_iteration(scale)
        try:
            yield t
        finally:
            for m in modes:
                m._end_iteration(first)


@contextlib.contextmanager
def recorded(name: str, work: Callable[[], Sequence[float]]):
    """One call of kernel ``name``: each active ``FlopCounter`` adds
    ``work()`` = (flops, bytes) and counts none of the ops inside.
    Without a counter, ``work`` is not called and nothing is done."""
    modes = _counters()
    if not modes:
        yield
        return
    flops, nbytes = work()
    with contextlib.ExitStack() as stack:
        for m in modes:
            m.add_kernel(name, flops, nbytes)
            stack.enter_context(m.suspended())
        yield


def _keep(t):
    return t


class _Counted(torch.autograd.Function):
    """A kernel call on the CPU or on ``meta`` under grad: the forward
    records it, the backward records its backward (the plain version's
    own, on the CPU; empty gradients on ``meta``)."""

    @staticmethod
    def forward(ctx, call, *inputs):
        ctx.call = call
        with recorded(call.name, call.work):
            if call.meta:
                outs = call.fn(*inputs)
                ctx.inputs = [(t.shape, t.dtype, t.device)
                              if isinstance(t, torch.Tensor) else None
                              for t in inputs]
            else:
                # the plain version's own graph, kept whole for the
                # backward: an enclosing checkpoint's hooks would drop its
                # saved tensors, and recompute the region to get them back
                with torch.enable_grad(), \
                        torch.autograd.graph.saved_tensors_hooks(
                            _keep, _keep):
                    leaves = [t.detach().requires_grad_(t.requires_grad)
                              if isinstance(t, torch.Tensor) else t
                              for t in inputs]
                    outs = call.fn(*leaves)
                ctx.graph = (leaves, outs)
            # contiguous, as the kernels write their outputs
            return tuple(o.detach().contiguous() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        call = ctx.call
        needs = ctx.needs_input_grad[1:]
        with recorded(call.name + "_bwd", call.bwd_work):
            if call.meta:
                return (None,) + tuple(
                    torch.empty(spec[0], dtype=spec[1], device=spec[2])
                    if need else None
                    for spec, need in zip(ctx.inputs, needs))
            leaves, outs = ctx.graph
            want = [t for t, need in zip(leaves, needs) if need]
            pairs = [(o, g) for o, g in zip(outs, grads)
                     if g is not None and o.requires_grad]
            got = iter(g if g is None else g.contiguous()
                       for g in torch.autograd.grad(
                           [o for o, _ in pairs], want,
                           [g for _, g in pairs], allow_unused=True))
            return (None,) + tuple(next(got) if need else None
                                   for need in needs)


@dataclass
class _Call:
    name: str
    work: Callable
    bwd_work: Callable
    fn: Callable
    meta: bool


def counted_call(name: str, work, bwd_work, fn, inputs, *, meta: bool):
    """``fn(*inputs)`` (a tuple of tensors) as one recorded call of kernel
    ``name``, its backward recorded as ``name + "_bwd"``: the plain
    version on the CPU, or on ``meta`` (``meta=True``) a function that
    returns empty outputs.  Used by the kernel wrappers on the CPU under a
    ``FlopCounter``, and on ``meta`` always."""
    call = _Call(name, work, bwd_work, fn, meta)
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in inputs):
        return _Counted.apply(call, *inputs)
    with recorded(name, work):
        return tuple(o.contiguous() for o in fn(*inputs))
