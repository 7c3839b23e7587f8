"""The port's dry run (``launch/dryrun.py``) and its aggregator
(``launch/roofline.py``) on the CPU: records of reduced configs on
``meta`` with every key the aggregator reads, each kernel's counted calls
as the step launches them, skipped cells written as records, the CLI on a
full-size cell; and the port's versions of ``tests/test_roofline.py``'s
four unit cases, ``fits`` against the H100's 80 GB."""
import json

import pytest

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import HBM_BYTES
from repro_torch.launch.roofline import (advice, fmt_row, load_records,
                                         markdown_table)
from repro_torch.models import registry as R
from repro_torch.models.config import ShapeSpec

ROOFLINE_KEYS = ("model_flops", "counted_flops_global", "useful_ratio",
                 "compute_s", "memory_s", "collective_s", "dominant",
                 "bound_s", "roofline_frac")
CELLS = [("minicpm-2b-smoke", "train_4k"), ("minicpm-2b-smoke", "prefill_32k"),
         ("minicpm-2b-smoke", "decode_32k"),
         ("granite-moe-3b-a800m-smoke", "train_4k"),
         ("recurrentgemma-9b-smoke", "long_500k"),
         ("xlstm-1.3b-smoke", "train_4k"),
         ("llama-3.2-vision-11b-smoke", "decode_32k"),
         ("hubert-xlarge-smoke", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_record_has_what_the_aggregator_reads(arch, shape, tmp_path):
    rec = dryrun.run_cell(arch, shape, str(tmp_path))
    assert "error" not in rec and "skip" not in rec
    assert rec["mesh"] == "1xH100" and rec["chips"] == 1
    assert set(ROOFLINE_KEYS) <= set(rec["roofline"])
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["roofline"]["collective_s"] == 0.0
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == sum(mem["argument_parts"].values())
    assert mem["temp_size_in_bytes"] > 0 and mem["temp_is_estimate"]
    assert rec["counted"]["collective_wire_bytes"] == {}
    assert rec["counted"]["flops"] > 0 and rec["counted"]["traffic_bytes"] > 0
    (path,) = tmp_path.glob("*.json")
    assert path.name == f"{arch}__{shape}__1xH100.json"
    row = fmt_row(json.loads(path.read_text()))
    assert row["mesh"] == "1xH100" and row["fits"] in ("Y", "OVER")


def test_train_record_counts_the_kernels_and_the_arguments():
    cfg = get_arch("minicpm-2b-smoke")
    rec = dryrun.lower_cell("minicpm-2b-smoke", ShapeSpec("t", 64, 4,
                                                          "train"),
                            accum_steps=2, remat="full")
    layers = cfg.n_layers
    # per microbatch and layer a forward, its recompute, and a backward
    assert {k: v["calls"] for k, v in rec["counted"]["kernels"].items()} \
        == {"flash_attention": layers * 2 * 2,
            "flash_attention_bwd": layers * 2}
    n = R.count_params_analytic(cfg)
    parts = rec["memory"]["argument_parts"]
    assert parts["parameters"] == parts["gradients"] == 4 * n
    assert parts["optimizer"] == 8 * n + 4
    assert parts["inputs"] == 2 * 4 * 64 * 4          # tokens and labels
    assert rec["roofline"]["model_flops"] == R.model_flops(cfg, 4 * 64)


def test_skipped_cells_are_written_as_records(tmp_path):
    for arch, shape in (("minicpm-2b-smoke", "long_500k"),
                        ("hubert-xlarge-smoke", "decode_32k")):
        rec = dryrun.run_cell(arch, shape, str(tmp_path))
        assert rec["skip"]
    recs = load_records(str(tmp_path))
    assert len(recs) == 2 and all("skip" in r for r in recs)


def test_cli_and_aggregator_on_a_full_size_cell(tmp_path, capsys):
    dryrun.main(["--arch", "h2o-danube-3-4b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "minicpm-2b", "--shape", "long_500k",
                 "--out", str(tmp_path)])
    rows = roofline.main(["--dir", str(tmp_path), "--advice"])
    out = capsys.readouterr().out
    assert len(rows) == 1 and rows[0]["arch"] == "h2o-danube-3-4b"
    assert rows[0]["next_move"]
    assert "| arch |" in out and "Skipped cells" in out
    assert "minicpm-2b x long_500k" in out
    rec = json.loads((tmp_path / "h2o-danube-3-4b__decode_32k__1xH100.json")
                     .read_text())
    # decode reads the whole cache: the cell is bound by memory
    assert rec["roofline"]["dominant"] == "memory"
    assert rec["memory"]["argument_parts"]["cache"] > 0


# the port's versions of tests/test_roofline.py's four unit cases
def _rec(**kw):
    base = {
        "arch": "a", "shape": "train_4k", "mesh": "1xH100",
        "memory": {"argument_size_in_bytes": 0,
                   "temp_size_in_bytes": 8 * 2**30},
        "counted": {"collective_wire_bytes": {"all-gather": 100.0}},
        "roofline": {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5,
                     "dominant": "memory", "useful_ratio": 0.5,
                     "roofline_frac": 0.1, "model_flops": 1e15,
                     "counted_flops_global": 2e15, "bound_s": 2.0},
    }
    base.update(kw)
    return base


def test_fmt_row_fits_flag():
    row = fmt_row(_rec())
    assert row["fits"] == "Y" and row["dom"] == "memory"
    assert row["mesh"] == "1xH100"
    # 80 GB: 64 GiB (68.7 GB) fits the H100, 75 GiB (80.5 GB) does not
    assert fmt_row(_rec(memory={"temp_size_in_bytes": 64 * 2**30}))[
        "fits"] == "Y"
    over = _rec(memory={"temp_size_in_bytes": 75 * 2**30})
    assert fmt_row(over)["fits"] == "OVER"
    # the arguments count too
    both = _rec(memory={"argument_size_in_bytes": HBM_BYTES // 2,
                        "temp_size_in_bytes": HBM_BYTES // 2 + 1})
    assert fmt_row(both)["fits"] == "OVER"


def test_markdown_table_shape():
    rows = [fmt_row(_rec()), fmt_row(_rec(arch="b"))]
    md = markdown_table(rows)
    lines = md.splitlines()
    assert lines[0].startswith("| arch |")
    assert len(lines) == 2 + 2


def test_advice_covers_each_dominant_term():
    assert "shard the" in advice(_rec(roofline={
        **_rec()["roofline"], "dominant": "memory", "useful_ratio": 0.1}))
    assert "all-gather" in advice(_rec(roofline={
        **_rec()["roofline"], "dominant": "collective"}))
    assert "replicated" in advice(_rec(roofline={
        **_rec()["roofline"], "dominant": "compute", "useful_ratio": 0.2}))
    assert "roof" in advice(_rec(roofline={
        **_rec()["roofline"], "dominant": "compute", "useful_ratio": 0.9}))


def test_load_records_filters_by_suffix(tmp_path):
    with open(tmp_path / "a__train_4k__1xH100.json", "w") as f:
        json.dump(_rec(), f)
    with open(tmp_path / "a__train_4k__1xH100__variant.json", "w") as f:
        json.dump(_rec(arch="variant"), f)
    base = load_records(str(tmp_path), "")
    var = load_records(str(tmp_path), "variant")
    assert len(base) == 1 and base[0]["arch"] == "a"
    assert len(var) == 1 and var[0]["arch"] == "variant"
