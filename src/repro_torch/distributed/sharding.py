"""Logical-axis -> mesh-axis sharding rules as DTensor placements (PyTorch
port of ``repro/distributed/sharding.py``).

Every parameter carries a tuple of logical axis names
(``models.transformer.logical_axes``).  A RULESET maps logical names to
mesh axes; ``logical_to_specs`` turns (axes tree, shapes tree) into a tree
of specs, dropping any mapping whose dimension is not divisible by the
mesh-axis size and any mesh axis used twice within one spec
(``safe_spec``).

A spec is a tuple with the meaning of the reference's ``PartitionSpec``:
one entry per leading tensor dim, each a mesh axis name, a tuple of axis
names (one tensor dim sharded over several mesh dims, major first) or
None; trailing Nones are dropped, so ``()`` is fully replicated.
``placements`` turns a spec into one ``Shard(d)`` / ``Replicate()`` per
dim of a ``DeviceMesh``; ``distribute_tree`` places a params or cache
tree.  The specs need no process group: ``abstract_mesh`` describes a
mesh by its axis sizes alone, as the reference's ``AbstractMesh`` does.

Baseline ruleset = TP over "model" for vocab/heads/mlp/rnn + ZeRO-style
FSDP over "data" for the d_model dim; params replicated over "pod" (pure
DP across pods).

The port keeps its layers in a list, so its leaves have no leading stacked
"layers" dim and ``cache_specs`` is the reference's with
``scanned=False``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch

Rules = Dict[str, Any]  # logical name -> mesh axis | tuple | None
Spec = Tuple[Any, ...]

RULESETS: Dict[str, Rules] = {
    # paper-faithful baseline: TP(model) x FSDP(data), experts TP-sliced
    "base": {
        "vocab": "model", "heads": "model", "kv": "model", "mlp": "model",
        "rnn": "model", "rnn_out": "model", "embed": "data",
        "experts": None, "conv": None, "layers": None, "kv_heads": None,
        "head_rnn": "model",
    },
    # expert-parallel variant: experts over model axis, expert-ffn unsharded
    "ep": {
        "vocab": "model", "heads": "model", "kv": "model", "mlp": None,
        "rnn": "model", "rnn_out": "model", "embed": "data",
        "experts": "model", "conv": None, "layers": None, "kv_heads": None,
        "head_rnn": "model",
    },
    # no-FSDP (replicated weights over data) — ablation / small models
    "tp_only": {
        "vocab": "model", "heads": "model", "kv": "model", "mlp": "model",
        "rnn": "model", "rnn_out": "model", "embed": None,
        "experts": None, "conv": None, "layers": None, "kv_heads": None,
        "head_rnn": "model",
    },
}


class AbstractMesh:
    """A mesh described by its axis names and sizes only: enough for the
    specs, without a process group."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for {len(axis_names)} "
                             f"axes")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))

    def __repr__(self):
        return f"AbstractMesh({self.shape})"


def abstract_mesh(shape: Sequence[int], axis_names: Sequence[str]):
    return AbstractMesh(shape, axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axis_size(sizes: Dict[str, int], axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def safe_spec(shape: Sequence[int], want: Sequence[Any], mesh) -> Spec:
    """Drop mesh axes that don't divide their dim or repeat within the spec."""
    sizes = mesh_shape(mesh)
    used = set()
    parts: list = []
    for dim, axis in zip(shape, want):
        if axis is None:
            parts.append(None)
            continue
        flat = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        if any(a in used for a in flat) or dim % _axis_size(sizes, axis):
            parts.append(None)
            continue
        used.update(flat)
        parts.append(tuple(axis) if isinstance(axis, list) else axis)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def map_leaves(fn, tree, *rest):
    """``fn`` over the leaves of dict/list trees whose leaves may be tuples
    (axes or specs), with ``rest`` of the same structure."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def logical_to_specs(axes_tree, shapes_tree, mesh, rules: Rules) -> Any:
    """Spec tree for a parameter tree; ``shapes_tree`` holds tensors (on
    ``meta`` for a full-size model) or shapes."""
    def one(axes: Tuple, leaf) -> Spec:
        want = [rules.get(a) if a else None for a in axes]
        return safe_spec(_shape(leaf), want, mesh)
    return map_leaves(one, axes_tree, shapes_tree)


def data_axes(mesh) -> Tuple[str, ...]:
    """The DP mesh axes: ("pod","data") on a multi-pod mesh else "data"."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _dp_axis(mesh):
    dp = data_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


def batch_specs(batch_shapes, mesh) -> Any:
    """Input-batch specs: leading dim over the DP axes when divisible."""
    dp_axis = _dp_axis(mesh)

    def one(leaf):
        shape = _shape(leaf)
        return safe_spec(shape, [dp_axis] + [None] * (len(shape) - 1), mesh)
    return map_leaves(one, batch_shapes)


def cache_specs(cache_shapes, mesh) -> Any:
    """Decode-cache specs: batch over DP axes; KV caches sequence-sharded
    over "model" (flash-decoding style).

    Decode attention contracts the feature dim, so a feature-sharded cache
    would be gathered whole every token; with the *sequence* dim sharded
    each rank reads just its slice and the softmax's partial sums are
    combined across "model" (``models.layers.decode_attention_block``).
    A cache shorter than 1024 slots, and recurrent state, shard the
    trailing feature dim instead."""
    dp_axis = _dp_axis(mesh)

    def one(leaf):
        shape = _shape(leaf)
        nd = len(shape)
        want: list = [None] * nd
        if nd:
            want[0] = dp_axis
        if nd >= 3 and shape[-3] >= 1024:
            want[-3] = "model"               # the (long) sequence dim
        elif nd >= 3:
            want[-1] = "model"               # recurrent state: feature dim
        return safe_spec(shape, want, mesh)
    return map_leaves(one, cache_shapes)


def placements(mesh, spec: Spec, shape=None):
    """One ``Shard(d)`` or ``Replicate()`` per dim of the ``DeviceMesh``
    ``mesh``, for ``spec``.  A tuple entry shards its tensor dim over
    several mesh dims, major first, which must be the mesh's order.  With
    the tensor's ``shape``, a dim of size 1 (which ``safe_spec`` shards
    only over mesh axes of size 1) stays replicated, as it is in effect:
    DTensor's reshapes fold such a dim away and refuse a sharded one."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, axis in enumerate(spec):
        if axis is None or (shape is not None and shape[d] == 1):
            continue
        flat = axis if isinstance(axis, tuple) else (axis,)
        order = [names.index(a) for a in flat]
        if order != sorted(order):
            raise ValueError(f"spec entry {axis} is not in the mesh's order "
                             f"{tuple(names)}")
        for i in order:
            out[i] = Shard(d)
    return tuple(out)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's piece on this rank, or the tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole on every rank (a collective of its mesh;
    a replicated one's value as it is), or the tensor itself."""
    return t.full_tensor() if is_dtensor(t) else t


def local_shard(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's piece of the whole tensor ``t`` under ``place``: its
    chunk along each sharded dim, mesh dims in order (major first).  A
    piece smaller than ``t`` is a copy, so that it does not hold the
    whole tensor's memory once the caller drops ``t``."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            t = t.chunk(mesh.mesh.shape[i], dim=p.dim)[coord[i]]
    t = t.contiguous()
    return t.clone() if t.untyped_storage().nbytes() > t.nbytes else t


def distribute_placed(t: torch.Tensor, mesh, place):
    """``t`` (the whole tensor, the same on every rank) as a DTensor with
    the placements ``place``: each rank keeps its own piece, so no
    collective runs."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_shard(t, mesh, place), mesh, place,
                              run_check=False, shape=t.shape,
                              stride=t.contiguous().stride())


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """``t`` (the whole tensor, the same on every rank) as a DTensor under
    ``spec``."""
    return distribute_placed(t, mesh, placements(mesh, spec, t.shape))


def distribute_batch(t, mesh):
    """A batch entry (a tensor, or what ``torch.as_tensor`` takes, made on
    the mesh's device type) as a DTensor placed by ``batch_specs``: its
    leading dim over the DP axes where it divides; a DTensor passes as it
    is."""
    if is_dtensor(t):
        return t
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t, device=mesh.device_type)
    return distribute(t, mesh, batch_specs([t], mesh)[0])


def distribute_tree(tree, specs, mesh):
    """A params or cache tree as DTensors on ``mesh`` under ``specs`` (a
    tree of specs shaped like ``tree``)."""
    return map_leaves(lambda t, s: distribute(t, mesh, s), tree, specs)
