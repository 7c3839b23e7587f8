"""The weights of a run, made by the benchmark from the seed.

The program's parameter tree gives the leaves and their types (its
initialiser on the ``meta`` device, which allocates nothing); the values
are drawn here, on the card, from one ``torch.Generator`` seeded with the
seed, one call for each kind of leaf with all layers stacked.  So the
program and the reference get the same numbers, and any leaf can be made
again later without keeping a copy.  Norm scales are drawn too (not left
at 0, which would hide them): the norms multiply by 1 + scale.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterator, List, Tuple

import torch

NORM_STD = 0.1


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{dotted path: leaf} of a nested dict / list tree, in its order."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def unflatten_into(template, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """A tree shaped like ``template`` with the leaves of ``flat``."""
    if isinstance(template, dict):
        return {k: unflatten_into(v, flat, f"{prefix}{k}.")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [unflatten_into(v, flat, f"{prefix}{i}.")
                for i, v in enumerate(template)]
    return flat[prefix[:-1]]


def kind_of(path: str) -> str:
    return re.sub(r"^layers\.\d+\.", "layers.*.", path)


def std_of(kind: str, shape, s: dict) -> float:
    """The scale of a kind of leaf: 1 / sqrt(fan-in), the residual
    branches' outputs by 1 / sqrt(2 L) more; norm scales NORM_STD; the
    embedding as below; a leaf name that the configuration file's
    ``init_std`` lists, that scale.  ``s``: the configuration's layers
    ``L``, width ``d``, whether the head is the embedding (``tied``) and
    ``init_std``."""
    name = kind.rsplit(".", 1)[-1]
    if name in s.get("init_std", {}):
        return float(s["init_std"][name])
    out = 1.0 / math.sqrt(2 * s["L"])
    if name in ("ln", "final_ln"):
        return NORM_STD
    if kind == "embed":
        # a tied table is read at sqrt(d) times its scale (the port's
        # lookup) and is also the head: at d^-1/2 the input token's own
        # logit would stand ~sqrt(d) deviations above the rest, so that a
        # random model only repeats its input and nothing between the
        # embedding and the head could move a served token; at 1 / d it
        # stands about one deviation above
        return 1.0 / s["d"] if s["tied"] else s["d"] ** -0.5
    if kind == "head":
        return s["d"] ** -0.5
    if name in ("wq", "wk", "wv", "router", "w1", "w3"):
        return shape[-2] ** -0.5
    if name in ("wo", "w2"):
        return shape[-2] ** -0.5 * out
    raise ValueError(f"no scale for a leaf {kind!r}: a new kind of layer "
                     f"needs its scale in the configuration file's "
                     f"init_std")


def groups(template: Dict[str, torch.Tensor]) -> List[Tuple[str, List[str]]]:
    """The leaf kinds in the tree's order, each with its leaves."""
    out: Dict[str, List[str]] = {}
    for path in template:
        out.setdefault(kind_of(path), []).append(path)
    return list(out.items())


def draw(template: Dict[str, torch.Tensor], sizes: dict, seed: int,
         device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, float32 values) of every leaf, in the tree's order of kinds:
    one normal draw a kind, all its leaves stacked, then scaled."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for kind, paths in groups(template):
        shape = tuple(template[paths[0]].shape)
        block = torch.randn((len(paths),) + shape, generator=gen,
                            device=device, dtype=torch.float32)
        block.mul_(std_of(kind, shape, sizes))
        for i, p in enumerate(paths):
            yield p, block[i]
        del block


def make(template: Dict[str, torch.Tensor], sizes: dict, seed: int, device,
         as_float32: bool = False) -> Dict[str, torch.Tensor]:
    """{path: leaf} on ``device``, each leaf in its template's type (or, with
    ``as_float32``, those values widened back to float32: the weights the
    program got, for the reference)."""
    out = {}
    for p, t in draw(template, sizes, seed, device):
        leaf = t.to(template[p].dtype)
        out[p] = leaf.float().clone() if as_float32 else leaf.clone()
    return out
