"""Conversion between the JAX package's parameter pytrees and the port's.

JAX layout: ``{"embed", "blocks": {"l<i>": layer}, "tail": [layer, ...],
"final_ln", "head"?}`` where every leaf under ``blocks`` has a leading
``n_scan_blocks`` dim (one slice per pattern period).  Port layout:
``{"embed", "layers": [layer, ...], "final_ln", "head"?}`` with one layer
per depth index.  Port layer ``n`` is ``blocks["l<n % P>"][n // P]`` for the
scanned periods and ``tail[n - n_scan_blocks * P]`` after them.

A JAX tree is given as nested dicts and lists of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives it.  Paths in errors are written
as ``jax.tree_util.keystr`` writes them, e.g. ``['blocks']['l0']['mix']['wq']``.

The optimizer state converts the same way: its moments ``m`` and ``v`` are
trees shaped like the params (``opt_state_to_jax``,
``opt_state_from_jax``).  ``tree_to_jax_flat`` and ``tree_from_jax_flat``
key a params-shaped tree by those JAX paths directly, keeping its tensors'
dtypes, as a checkpoint stores them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWState

Path = Tuple[Any, ...]


def keystr(path: Path) -> str:
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in path)


def flatten_with_paths(tree, path: Path = ()) -> Dict[str, Any]:
    """{keystr path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(flatten_with_paths(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten_with_paths(v, path + (i,)))
        return out
    return {keystr(path): tree}


def _map_with_path(tree, fn: Callable[[Path, Any], Any], path: Path = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _jax_location(cfg: ArchConfig, path: Path):
    """(JAX keystr path, index into the stacked dim or None) of a port leaf."""
    if path[0] != "layers":
        return keystr(path), None
    n, rest = path[1], path[2:]
    P = cfg.pattern_period
    scanned = cfg.n_scan_blocks * P
    if n < scanned:
        return keystr(("blocks", f"l{n % P}") + rest), n // P
    return keystr(("tail", n - scanned) + rest), None


def decay_mask(cfg: ArchConfig, params):
    """A tree of bools shaped like ``params``: the leaves the reference's
    AdamW decays.  It decays a leaf of rank >= 2 in its own layout, where
    every leaf of a scanned layer carries the leading period axis, so a
    scanned layer's vectors (norm scales, biases, Griffin's ``lam``) are
    decayed and a tail layer's and the top-level ones are not."""
    def rule(path: Path, p) -> bool:
        _, idx = _jax_location(cfg, path)
        return p.dim() + (idx is not None) >= 2
    return _map_with_path(params, rule)


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":           # ml_dtypes' bf16 from JAX
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:              # numpy has no bf16
        t = t.float()
    return t.numpy()


def params_from_jax(cfg: ArchConfig, tree, *, device="cpu"):
    """The port's params from a JAX params tree of numpy arrays.

    Raises KeyError naming the path if a port weight has no JAX leaf or a
    JAX leaf is left unused, and ValueError on a shape mismatch.
    """
    flat = {k: np.asarray(v) for k, v in flatten_with_paths(tree).items()}
    return _from_flat(cfg, flat, _to_torch, device)


def _from_flat(cfg: ArchConfig, flat: Dict[str, Any], to_torch, device,
               prefix: str = ""):
    """A params-shaped port tree of ``to_torch(leaf)`` on ``device`` from
    {prefix + JAX keystr path: leaf}; every key under ``prefix`` used."""
    template = tf.init_params(cfg, device="meta")
    flat = {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}
    used = set()

    def take(path: Path, like: torch.Tensor):
        jpath, idx = _jax_location(cfg, path)
        if jpath not in flat:
            raise KeyError(f"JAX params have no leaf {jpath} for the port's "
                           f"{keystr(path)}")
        used.add(jpath)
        arr = flat[jpath]
        if idx is not None:
            if arr.ndim == 0 or arr.shape[0] != cfg.n_scan_blocks:
                raise ValueError(f"{jpath}: expected a leading dim of "
                                 f"{cfg.n_scan_blocks} scanned blocks, got "
                                 f"shape {arr.shape}")
            arr = arr[idx]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{jpath}: shape {tuple(arr.shape)} does not "
                             f"match the port's {keystr(path)} "
                             f"{tuple(like.shape)}")
        return to_torch(arr).to(device)

    out = _map_with_path(template, take)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"JAX params leaves the port does not use: "
                       f"{', '.join(unused)}")
    return out


def _tree_to_numpy(tree):
    return _map_with_path(tree, lambda _, t: _to_numpy(t))


def _stack(layers):
    """Per-layer trees of one pattern position -> one tree, stacked leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers]) for k in first}
    return torch.stack([t.detach() for t in layers])


def _to_jax_layout(cfg: ArchConfig, tree):
    """A params-shaped port tree in the JAX layout: the layers of each
    pattern position stacked over the scanned blocks, then the tail; the
    tensors' dtypes and device kept."""
    layers = tree["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer "
                         f"config")
    P, n_scan = cfg.pattern_period, cfg.n_scan_blocks
    out = {k: v for k, v in tree.items() if k != "layers"}
    if n_scan:
        out["blocks"] = {f"l{i}": _stack([layers[j * P + i]
                                          for j in range(n_scan)])
                         for i in range(P)}
    if cfg.n_tail_layers:
        out["tail"] = [layers[n_scan * P + i]
                       for i in range(cfg.n_tail_layers)]
    return out


def params_to_jax(cfg: ArchConfig, params):
    """The JAX params layout (numpy arrays; bf16 as float32) of port params."""
    return _tree_to_numpy(_to_jax_layout(cfg, params))


def opt_state_to_jax(cfg: ArchConfig, state: AdamWState):
    """(step, m, v) of a port AdamW state in the JAX layout, numpy arrays,
    in the order of the JAX package's ``AdamWState`` fields."""
    return (_to_numpy(state.step), params_to_jax(cfg, state.m),
            params_to_jax(cfg, state.v))


def opt_state_from_jax(cfg: ArchConfig, state, *, device="cpu"):
    """The port's AdamW state from a JAX one ((step, m, v) of numpy
    arrays, or anything with those fields)."""
    step, m, v = state
    return AdamWState(
        step=torch.tensor(np.asarray(step), dtype=torch.int32,
                          device=device),
        m=params_from_jax(cfg, m, device=device),
        v=params_from_jax(cfg, v, device=device))


def tree_to_jax_flat(cfg: ArchConfig, tree,
                     prefix: str = "") -> Dict[str, torch.Tensor]:
    """{prefix + JAX keystr path: tensor} of a params-shaped port tree in
    the JAX layout; dtypes kept."""
    return {prefix + k: t.detach() for k, t in
            flatten_with_paths(_to_jax_layout(cfg, tree)).items()}


def tree_from_jax_flat(cfg: ArchConfig, flat: Dict[str, torch.Tensor],
                       prefix: str = "", *, device="cpu"):
    """The params-shaped port tree under ``prefix`` of a flat
    {JAX keystr path: tensor}, as ``tree_to_jax_flat`` keys it."""
    return _from_flat(cfg, flat, torch.as_tensor, device, prefix)


def cache_to_jax(cfg: ArchConfig, cache):
    """The JAX decode-cache layout (numpy arrays) of a port cache."""
    out = _tree_to_numpy(_to_jax_layout(cfg, cache))
    out.setdefault("blocks", {})
    out.setdefault("tail", [])
    return out
