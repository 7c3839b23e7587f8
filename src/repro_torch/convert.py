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
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ArchConfig

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
    template = tf.init_params(cfg, device="meta")
    flat = flatten_with_paths(tree)
    used = set()

    def take(path: Path, like: torch.Tensor):
        jpath, idx = _jax_location(cfg, path)
        if jpath not in flat:
            raise KeyError(f"JAX params have no leaf {jpath} for the port's "
                           f"{keystr(path)}")
        used.add(jpath)
        arr = np.asarray(flat[jpath])
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
        return _to_torch(arr).to(device)

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
    return np.stack([_to_numpy(t) for t in layers])


def _to_jax_layout(cfg: ArchConfig, tree):
    layers = tree["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a {cfg.n_layers}-layer "
                         f"config")
    P, n_scan = cfg.pattern_period, cfg.n_scan_blocks
    out = {k: _tree_to_numpy(v) for k, v in tree.items() if k != "layers"}
    if n_scan:
        out["blocks"] = {f"l{i}": _stack([layers[j * P + i]
                                          for j in range(n_scan)])
                         for i in range(P)}
    if cfg.n_tail_layers:
        out["tail"] = [_tree_to_numpy(layers[n_scan * P + i])
                       for i in range(cfg.n_tail_layers)]
    return out


def params_to_jax(cfg: ArchConfig, params):
    """The JAX params layout (numpy arrays; bf16 as float32) of port params."""
    return _to_jax_layout(cfg, params)


def cache_to_jax(cfg: ArchConfig, cache):
    """The JAX decode-cache layout (numpy arrays) of a port cache."""
    out = _to_jax_layout(cfg, cache)
    out.setdefault("blocks", {})
    out.setdefault("tail", [])
    return out
