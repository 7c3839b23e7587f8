"""Step-atomic checkpoints in the JAX package's on-disk layout (PyTorch port
of ``repro/checkpoint/store.py``), so that a checkpoint written by either
restores in the other:

    <root>/step_00001230.tmp0/...     # in-flight write
    <root>/step_00001230/
        manifest.msgpack              # step, meta, compress, leaves
                                      #   (shape and dtype of each)
        host0000.npz                  # each leaf's raw bytes, as uint8
    <root>/LATEST                     # text file, atomically replaced

Leaves are keyed by their paths in the JAX layout: the params through
``convert`` (``params['blocks']['l0']['mix']['wq']``, stacked over the
scanned blocks), an AdamW state as the JAX ``AdamWState`` flattens
(``opt.step``, ``opt.m[...]``, ``opt.v[...]``).  bf16 is stored as its
raw bytes under the dtype name ``bfloat16``, as the JAX package stores it.
The manifest is written and read by the port's own MessagePack codec.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint.msgpack_codec import packb, unpackb
from repro_torch.models.config import ArchConfig
from repro_torch.optim import AdamWState
from repro_torch.tree import tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _raw(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:               # numpy has no bf16
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_raw(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype not in _DTYPES:
        raise ValueError(f"checkpoint leaf of dtype {dtype!r}; known: "
                         f"{sorted(_DTYPES)}")
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, np.int16).copy()
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(dtype)).copy()) \
        .reshape(shape)


def flatten_trees(cfg: ArchConfig, trees: Dict[str, Any]
                  ) -> Dict[str, torch.Tensor]:
    """{JAX-layout key: tensor} of {name: params-shaped tree or AdamWState}."""
    flat: Dict[str, torch.Tensor] = {}
    for name, tree in trees.items():
        if isinstance(tree, AdamWState):
            flat[f"{name}.step"] = tree.step
            flat.update(convert.tree_to_jax_flat(cfg, tree.m, f"{name}.m"))
            flat.update(convert.tree_to_jax_flat(cfg, tree.v, f"{name}.v"))
        else:
            flat.update(convert.tree_to_jax_flat(cfg, tree, name))
    return flat


def save_checkpoint(root: str, step: int, flat: Dict[str, torch.Tensor],
                    meta: Optional[dict] = None, *, host_id: int = 0,
                    compress: bool = False) -> str:
    """Write {key: tensor} atomically. Returns the committed directory."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + f".tmp{host_id}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {"step": step, "meta": meta or {},
                                "compress": compress, "leaves": {}}
    payload: Dict[str, np.ndarray] = {}
    for key, t in flat.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"{key}: cannot store dtype {t.dtype}")
        manifest["leaves"][key] = {"shape": list(t.shape),
                                   "dtype": _NAMES[t.dtype]}
        raw = _raw(t)
        payload[key] = np.frombuffer(zlib.compress(raw, 1) if compress
                                     else raw, np.uint8)
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
    np.savez(os.path.join(tmp, f"host{host_id:04d}.npz"), **payload)
    # step-atomic commit
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _write_latest(root, step)
    return final


def _write_latest(root: str, step: int):
    fd, tmp = tempfile.mkstemp(dir=root)
    with os.fdopen(fd, "w") as f:
        f.write(str(step))
    os.replace(tmp, os.path.join(root, "LATEST"))


def latest_step(root: str) -> Optional[int]:
    """Newest committed step (its directory must hold a manifest)."""
    marker = os.path.join(root, "LATEST")
    candidates = []
    if os.path.exists(marker):
        with open(marker) as f:
            try:
                candidates.append(int(f.read().strip()))
            except ValueError:
                pass
    if os.path.isdir(root):  # fall back to scanning committed dirs
        for d in os.listdir(root):
            if d.startswith("step_") and ".tmp" not in d:
                try:
                    candidates.append(int(d.split("_")[1]))
                except (IndexError, ValueError):
                    continue
    valid = [s for s in sorted(set(candidates), reverse=True)
             if os.path.exists(os.path.join(
                 root, f"step_{s:08d}", "manifest.msgpack"))]
    return valid[0] if valid else None


def load_checkpoint(root: str, step: Optional[int] = None
                    ) -> Tuple[int, Dict[str, torch.Tensor], dict]:
    """Returns (step, {key: CPU tensor}, meta)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    leaves: Dict[str, torch.Tensor] = {}
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".npz"):
            continue
        with np.load(os.path.join(d, fn)) as z:
            for key in z.files:
                info = manifest["leaves"][key]
                raw = z[key].tobytes()
                if manifest.get("compress"):
                    raw = zlib.decompress(raw)
                leaves[key] = _from_raw(raw, info["dtype"], info["shape"])
    return manifest["step"], leaves, manifest.get("meta", {})


def restore_into(cfg: ArchConfig, template, leaves: Dict[str, torch.Tensor],
                 name: str):
    """A tree like ``template`` (params-shaped, or an AdamWState) from the
    leaves under ``name``, each cast to the template's dtype (a bf16
    round trip) and put on its device."""
    if isinstance(template, AdamWState):
        key = f"{name}.step"
        if key not in leaves:
            raise KeyError(f"checkpoint missing leaf {key}")
        return AdamWState(
            step=leaves[key].to(template.step.device, template.step.dtype),
            m=restore_into(cfg, template.m, leaves, f"{name}.m"),
            v=restore_into(cfg, template.v, leaves, f"{name}.v"))
    tree = convert.tree_from_jax_flat(cfg, leaves, name)
    return tree_map(lambda t, like: t.to(like.device, like.dtype), tree,
                    template)


class CheckpointManager:
    """Keep-last-k manager with auto-resume, for one model config."""

    def __init__(self, root: str, cfg: ArchConfig, keep: int = 3,
                 host_id: int = 0):
        self.root = root
        self.cfg = cfg
        self.keep = keep
        self.host_id = host_id

    def save(self, step: int, trees: Dict[str, Any],
             meta: Optional[dict] = None) -> str:
        path = save_checkpoint(self.root, step,
                               flatten_trees(self.cfg, trees), meta,
                               host_id=self.host_id)
        self._gc()
        return path

    def _gc(self):
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.root)
            if d.startswith("step_") and ".tmp" not in d
            and os.path.exists(os.path.join(self.root, d, "manifest.msgpack")))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, templates: Dict[str, Any]):
        """Returns (step, {name: tree}, meta) or None if no checkpoint."""
        step = latest_step(self.root)
        if step is None:
            return None
        step, leaves, meta = load_checkpoint(self.root, step)
        return step, {name: restore_into(self.cfg, tmpl, leaves, name)
                      for name, tmpl in templates.items()}, meta
