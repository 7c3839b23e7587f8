"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the checkout (the repository's ``testpaths`` leave them out).
Cells here run the port's plain versions on the CPU at its smoke sizes;
tests marked ``gpu`` need a CUDA card and skip without one."""
import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def smoke_config(conf: dict) -> dict:
    """A configuration file's content cut to the port's smoke config of
    the same architecture (the widths the file states follow it)."""
    from repro_torch.configs import get_arch
    conf = copy.deepcopy(conf)
    conf["arch"] += "-smoke"
    c = get_arch(conf["arch"])
    conf["model"].update({
        "num_hidden_layers": c.n_layers, "hidden_size": c.d_model,
        "num_attention_heads": c.n_heads,
        "num_key_value_heads": c.n_kv_heads, "head_dim": c.head_dim,
        "intermediate_size": c.d_ff, "vocab_size": c.vocab_size})
    if c.n_experts:
        conf["model"].update({"num_local_experts": c.n_experts,
                              "num_experts_per_tok": c.top_k})
    # the port's scalars as run, at the smoke widths
    as_run = {"scale_emb": c.d_model ** 0.5,
              "scale_depth": c.n_layers ** 0.5,
              "dim_model_base": c.d_model,
              "attention_multiplier": c.head_dim ** -0.5}
    for k, v in conf.get("port_departs", {}).items():
        if k in as_run:
            v["as_run"] = as_run[k]
    return conf


def smoke_traffic(mix: dict) -> dict:
    mix = copy.deepcopy(mix)
    if mix["driver"] == "train":
        mix["seq_len"] = 64
    else:
        mix["prompt"].update(median=40, min=8, max=100)
        mix["slots"] = mix["clients"] = 4
        mix["check_served_tokens"] = 30
    return mix


@pytest.fixture
def smoke_cell(monkeypatch):
    """smoke_cell(name) -> the cell ``name`` of BENCHMARK.json at smoke
    size, and its limits.  Without a card, the few ``torch.cuda`` calls
    that a run makes around the program read as a card that holds
    nothing, so that the rest of a run is driven on the CPU."""
    import torch
    from pbench import cells, runner
    if not torch.cuda.is_available():
        for name, value in (("reset_peak_memory_stats", None),
                            ("max_memory_allocated", 0),
                            ("memory_stats", {}),
                            ("get_device_name", "cpu")):
            monkeypatch.setattr(torch.cuda, name,
                                lambda *a, v=value, **k: v)

    def make(name):
        bench = cells.load_json(ROOT / "BENCHMARK.json")
        cell = cells.load(bench, ROOT, name)
        cell.config = smoke_config(cell.config)
        cell.traffic = smoke_traffic(cell.traffic)
        return cell, runner.limits_for(name)
    return make


TRAIN_CELLS = ["minicpm-2b.train-4k", "granite-moe-3b-a800m.train-4k"]
SERVE_CELLS = ["granite-moe-3b-a800m.serve-docs", "minicpm-2b.serve-docs"]
