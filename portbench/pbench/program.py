"""The program under test: the port's configuration of a cell's model,
checked against the benchmark's configuration file, and the kernels'
launch counters by route."""
from __future__ import annotations

import dataclasses
import importlib

# the port's ArchConfig field of each number the configuration file states
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
          "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
          "intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "num_local_experts": "n_experts",
          "num_experts_per_tok": "top_k",
          "capacity_factor": "capacity_factor",
          "tie_word_embeddings": "tie_embeddings",
          "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta"}


def model_as_run(conf: dict) -> dict:
    """The configuration file's published ``model`` with the port's
    departures (``port_departs``) in their place: what the port runs."""
    m = dict(conf["model"])
    m.update({k: v["as_run"] for k, v in conf.get("port_departs",
                                                   {}).items()})
    return m


def reference(conf: dict):
    """The plain reference module that a configuration file names
    (``portbench/reference/<reference>.py``)."""
    return importlib.import_module(f"reference.{conf['reference']}")


def arch(conf: dict):
    """The port's ArchConfig for a configuration file, in the type the file
    states; raises where the port's config differs from the file's model
    as run (``model_as_run``), or where the file's reference does not
    cover the port's family."""
    from repro_torch.configs import get_arch
    cfg = get_arch(conf["arch"])
    want = conf["as_run"]["dtype"]
    if cfg.dtype != want:
        cfg = dataclasses.replace(cfg, dtype=want)
    ref = reference(conf)
    if cfg.family not in ref.FAMILIES or cfg.act not in ref.ACTS:
        raise ValueError(f"{cfg.name}: {cfg.family} with {cfg.act}: "
                         f"reference.{conf['reference']} covers "
                         f"{ref.FAMILIES} with {ref.ACTS}")
    run = model_as_run(conf)
    bad = {k: (v, getattr(cfg, f)) for k, f in FIELDS.items()
           for v in [run.get(k)]
           if v is not None and getattr(cfg, f) != v}
    if bad:
        raise ValueError(f"{cfg.name}: the port's config differs from "
                         f"the configuration file: {bad}")
    return cfg


def sizes(conf: dict) -> dict:
    m = model_as_run(conf)
    return {"L": m["num_hidden_layers"], "d": m["hidden_size"],
            "tied": bool(m["tie_word_embeddings"]),
            "init_std": conf.get("init_std", {})}


def launches_by_route() -> dict:
    """{kernel: {route: launches}} of the flash and expert-FFN kernels."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.moe_gmm import kernel as mk
    out = {"flash_attention": dict(fk.LAUNCHES_BY_ROUTE),
           "flash_attention_bwd": dict(fk.BWD_LAUNCHES_BY_ROUTE),
           "moe_gmm": dict(mk.LAUNCHES_BY_ROUTE),
           "moe_gmm_bwd": dict(mk.BWD_LAUNCHES_BY_ROUTE)}
    return out


def off_route(before: dict, after: dict, route: str) -> int:
    """Launches between two readings on another route than ``route``."""
    n = 0
    for kernel, by in after.items():
        for r, c in by.items():
            if r != route:
                n += c - before.get(kernel, {}).get(r, 0)
    return n
