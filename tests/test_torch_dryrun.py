"""The port's dry run (``launch/dryrun.py``) and its aggregator
(``launch/roofline.py``) on the CPU: records of reduced configs on
``meta`` with every key the aggregator reads, each kernel's counted calls
as the step launches them, skipped cells written as records, the CLI on a
full-size cell; and the port's versions of ``tests/test_roofline.py``'s
four unit cases, ``fits`` against the H100's 80 GB."""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import HBM_BYTES
from repro_torch.launch.roofline import (advice, fmt_row, load_records,
                                         markdown_table)
from repro_torch.models import registry as R
from repro_torch.models.config import ShapeSpec
from repro_torch.tree import tree_leaves

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


def _train_state_bytes(rec):
    parts = rec["memory"]["argument_parts"]
    return parts["parameters"] + parts["gradients"] + parts["optimizer"]


def test_train_cell_on_fake_ranks_is_counted_per_card():
    """A train cell on 2 x 2 fake ranks: a record, each card holding about
    a quarter of the float32 parameters, their gradients and moments (the
    norm scales are split over "data" only), and collectives moving
    bytes; the flash kernel and its backward run on each card's rows and
    heads."""
    shape = ShapeSpec("t", 64, 4, "train")
    one = dryrun.lower_cell("minicpm-2b-smoke", shape)
    four = dryrun.lower_cell("minicpm-2b-smoke", shape, dp=2, tp=2)
    assert "skip" not in four and "error" not in four
    assert four["mesh"] == "2x2xH100" and four["chips"] == 4
    parts = four["memory"]["argument_parts"]
    assert parts["gradients"] == parts["parameters"]
    assert _train_state_bytes(four) / _train_state_bytes(one) == \
        pytest.approx(0.25, rel=0.02)
    assert four["counted"]["total_wire_bytes"] > 0
    assert four["roofline"]["collective_s"] > 0
    assert {k: v["calls"] for k, v in four["counted"]["kernels"].items()} \
        == {k: v["calls"] for k, v in one["counted"]["kernels"].items()}
    fl = {r["chips"]: r["counted"]["kernels"]["flash_attention_bwd"]["flops"]
          for r in (one, four)}
    # half the batch at half the heads
    assert fl[4] * 4 == pytest.approx(fl[1])


def test_dp_compress_needs_the_pod_axis(tmp_path):
    shape = ShapeSpec("t", 64, 4, "train")
    for kw in ({}, {"dp": 2, "tp": 2}):
        rec = dryrun.lower_cell("minicpm-2b-smoke", shape, dp_compress=True,
                                **kw)
        assert rec["skip"] == "dp_compress needs the pod axis"
        assert rec["dp_compress"]
    # with it: the int8 payloads all-reduced as int32 over "pod", each
    # pod's card holding half of its 1 x 2 submesh's share
    rec = dryrun.lower_cell("minicpm-2b-smoke", shape, tp=2, multi_pod=True,
                            dp_compress=True)
    assert "skip" not in rec and rec["mesh"] == "2x1x2xH100"
    parts = rec["memory"]["argument_parts"]
    assert parts["errors"] == parts["gradients"] == parts["parameters"]
    n_leaves = len(tree_leaves(R.init_params(get_arch("minicpm-2b-smoke"),
                                             device="meta")))
    assert rec["counted"]["collective_calls"]["all-reduce"] > n_leaves
    dryrun.main(["--arch", "minicpm-2b", "--shape", "train_4k",
                 "--dp-compress", "--out", str(tmp_path)])
    (path,) = tmp_path.glob("*.json")
    assert json.loads(path.read_text())["skip"] == \
        "dp_compress needs the pod axis"


def test_moe_train_cell_on_a_mesh_keeps_its_skip():
    """What this test holds, whatever its name says: a MoE train cell on a
    mesh carries no skip and is counted (d_ff split under ``base``), and
    so are the vision and audio train cells, each with the flash kernel's
    forward and backward.  The name is the one the test had while MoE
    cells were refused on a mesh."""
    rec = dryrun.lower_cell("granite-moe-3b-a800m-smoke",
                            ShapeSpec("t", 64, 4, "train"), tp=2)
    assert "skip" not in rec and "error" not in rec
    assert rec["moe"]["experts_per_card"] == 4     # base: d_ff split
    assert rec["moe"]["d_ff_per_card"] == rec["moe"]["d_ff"] // 2
    for arch in ("llama-3.2-vision-11b-smoke", "hubert-xlarge-smoke"):
        rec = dryrun.lower_cell(arch, ShapeSpec("t", 64, 4, "train"), tp=2)
        assert "skip" not in rec and "error" not in rec
        kernels = rec["counted"]["kernels"]
        assert kernels["flash_attention"]["calls"] > 0
        assert kernels["flash_attention_bwd"]["calls"] > 0


MOE_SMOKE = ("granite-moe-3b-a800m-smoke", "mixtral-8x7b-smoke")


@pytest.mark.parametrize("arch", MOE_SMOKE)
@pytest.mark.parametrize("ruleset", ["base", "ep"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_no_moe_cell_on_a_mesh_is_skipped(arch, ruleset, kind):
    rec = dryrun.lower_cell(arch, ShapeSpec("s", 64, 4, kind), dp=2, tp=2,
                            ruleset=ruleset)
    assert "skip" not in rec and "error" not in rec, rec.get("skip")
    assert rec["counted"]["kernels"]["moe_gmm"]["calls"] > 0
    assert rec["counted"]["total_wire_bytes"] > 0


RECURRENT_SMOKE = ("recurrentgemma-9b-smoke", "xlstm-1.3b-smoke")


def _kinds(cfg):
    return [cfg.block_pattern[n % cfg.pattern_period]
            for n in range(cfg.n_layers)]


@pytest.mark.parametrize("arch", RECURRENT_SMOKE)
@pytest.mark.parametrize("kind,mesh", [("prefill", dict(tp=8)),
                                       ("decode", dict(tp=8)),
                                       ("train", dict(dp=4, tp=4))])
def test_recurrent_cells_on_a_mesh_are_counted(arch, kind, mesh):
    """The RG-LRU and xLSTM cells on fake ranks carry no skip: the scan
    kernel once a recurrent layer in a forward (and its backward once in a
    train step: no remat at smoke size), none in decode, and collectives
    on the wire."""
    cfg = get_arch(arch)
    rec = dryrun.lower_cell(arch, ShapeSpec("s", 64, 4, kind), **mesh)
    assert "skip" not in rec and "error" not in rec, rec.get("skip")
    kinds = _kinds(cfg)
    name = "rglru_scan" if "rglru" in kinds else "mlstm_scan"
    layers = kinds.count(name.split("_")[0])
    kernels = {k: v["calls"] for k, v in rec["counted"]["kernels"].items()}
    if kind == "decode":
        assert name not in kernels
    else:
        assert kernels[name] == layers
        assert kernels.get(name + "_bwd", 0) == (layers if kind == "train"
                                                 else 0)
    assert rec["counted"]["total_wire_bytes"] > 0


@pytest.mark.parametrize("arch,tp,split", [
    ("recurrentgemma-9b-smoke", 2, 2), ("xlstm-1.3b-smoke", 2, 2),
    # 4 mLSTM heads do not split over 8 ranks: whole on every card
    ("xlstm-1.3b-smoke", 8, 1)])
def test_recurrent_kernels_count_a_cards_share(arch, tp, split):
    """Each scan kernel is counted at a rank's shapes: its FLOPs on a card
    of a tp-way mesh are 1 / ``split`` of one card's, D / tp channels of
    the RG-LRU, H / tp heads of the mLSTM (all H where H does not divide
    tp)."""
    name = "rglru_scan" if arch.startswith("recurrent") else "mlstm_scan"
    shape = ShapeSpec("p", 64, 4, "prefill")
    one, sharded = (dryrun.lower_cell(arch, shape, **kw)["counted"]
                    ["kernels"][name]["flops"] for kw in ({}, {"tp": tp}))
    assert sharded * split == pytest.approx(one)


MODAL_SMOKE = ("llama-3.2-vision-11b-smoke", "hubert-xlarge-smoke")


def _attn_layers(cfg):
    return _kinds(cfg).count("attn")


@pytest.mark.parametrize("arch,kind", [(a, k) for a in MODAL_SMOKE
                                       for k in ("prefill", "decode",
                                                 "train")
                                       if not (a.startswith("hubert") and
                                               k == "decode")])
@pytest.mark.parametrize("ruleset", ["base", "tp_only"])
def test_modal_cells_on_a_mesh_are_counted(arch, kind, ruleset):
    """The vision and audio cells on fake ranks carry no skip: the flash
    kernel once a self-attention layer in a forward, not in decode, its
    backward once a layer in a train step (no remat at smoke size), and
    collectives on the wire."""
    cfg = get_arch(arch)
    rec = dryrun.lower_cell(arch, ShapeSpec("s", 64, 4, kind), dp=2, tp=2,
                            ruleset=ruleset)
    assert "skip" not in rec and "error" not in rec, rec.get("skip")
    kernels = {k: v["calls"] for k, v in rec["counted"]["kernels"].items()}
    layers = _attn_layers(cfg)
    want = {} if kind == "decode" else {"flash_attention": layers}
    if kind == "train":
        want["flash_attention_bwd"] = layers
    assert kernels == want
    assert rec["counted"]["total_wire_bytes"] > 0


@pytest.mark.parametrize("arch", MODAL_SMOKE)
def test_modal_compressed_train_cells_are_counted(arch):
    """``--dp-compress`` on the multi-pod mesh: the vision and audio train
    cells' int8 payloads all-reduced over "pod", one a leaf at least."""
    rec = dryrun.lower_cell(arch, ShapeSpec("t", 64, 4, "train"), tp=2,
                            multi_pod=True, dp_compress=True)
    assert "skip" not in rec and "error" not in rec
    assert rec["mesh"] == "2x1x2xH100" and rec["dp_compress"]
    n_leaves = len(tree_leaves(R.init_params(get_arch(arch),
                                             device="meta")))
    assert rec["counted"]["collective_calls"]["all-reduce"] > n_leaves
    assert rec["counted"]["kernels"]["flash_attention_bwd"]["calls"] > 0


def test_audio_decode_on_a_mesh_keeps_its_encoder_only_skip(tmp_path):
    rec = dryrun.run_cell("hubert-xlarge", "decode_32k", str(tmp_path),
                          dp=2, tp=4)
    assert rec["skip"] == "encoder-only: no decode step"
    assert rec["mesh"] == "2x4xH100" and "counted" not in rec


@pytest.mark.parametrize("arch", MODAL_SMOKE)
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_flash_is_counted_at_a_cards_local_heads(arch, kind):
    """The flash kernel's FLOPs (and its backward's) on a card of a 1 x 4
    mesh are a quarter of one card's: H / 4 heads of the vision model's
    and the encoder's, not causal for the encoder."""
    shape = ShapeSpec("s", 64, 4, kind)
    one, sharded = (dryrun.lower_cell(arch, shape, **kw)["counted"]
                    ["kernels"] for kw in ({}, {"tp": 4}))
    assert set(one) == set(sharded)
    for name in one:
        assert sharded[name]["flops"] * 4 == pytest.approx(one[name]["flops"])


def test_cross_decode_over_a_sequence_sharded_patch_cache_all_reduces(
        monkeypatch):
    """A decode step of the reduced vision model on a 1 x 4 mesh: with
    1024 patches each CROSS layer's ck / cv are sequence-sharded over
    "model" and its attention's partials are combined by three
    all-reduces (the row max, the sum of exponentials, the weighted
    outputs); with 16 patches the cache is feature-sharded and gathered
    whole instead."""
    from repro_torch.launch import dryrun as D
    base = get_arch("llama-3.2-vision-11b-smoke")
    n_cross = _kinds(base).count("cross")
    calls = {}
    for n_patches in (16, 1024):
        cfg = dataclasses.replace(base, n_patches=n_patches)
        monkeypatch.setattr(D, "get_arch", lambda name, cfg=cfg: cfg)
        rec = D.lower_cell("llama-3.2-vision-11b-smoke",
                           ShapeSpec("d", 64, 4, "decode"), tp=4)
        assert "skip" not in rec and "error" not in rec
        calls[n_patches] = rec["counted"]["collective_calls"]
    assert calls[1024]["all-reduce"] - calls[16]["all-reduce"] == \
        3 * n_cross
    assert calls[16]["all-gather"] > calls[1024]["all-gather"]


def _bytes_per_card(cfg, mesh, ruleset):
    """A card's share of the serving weights, from the specs alone: each
    leaf's bytes over the sizes of the mesh axes its spec names."""
    from repro_torch.distributed import sharding
    params = R.init_params(cfg, device="meta")
    specs = sharding.logical_to_specs(R.logical_axes(cfg), params, mesh,
                                      sharding.RULESETS[ruleset])
    sizes = sharding.mesh_shape(mesh)

    def share(spec, p):
        div = 1
        for axis in spec:
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                div *= sizes[a] if a else 1
        return p.numel() * p.element_size() // div
    return sum(tree_leaves(sharding.map_leaves(share, specs, params)))


def test_mixtral_at_full_depth_holds_two_experts_a_card_under_ep():
    """mixtral-8x7b at all 32 layers on rank 0 of a 1 x 4 mesh of fake
    ranks under ``ep``: 2 of its 8 experts a card, whole (d_ff 14336), and
    the card's parameters what the specs give it: a quarter of the
    experts' 87 GiB, with the attention heads and vocabulary split too."""
    from repro_torch.distributed import sharding
    cfg = get_arch("mixtral-8x7b")
    rec = dryrun.lower_cell("mixtral-8x7b", ShapeSpec("p", 64, 4, "prefill"),
                            tp=4, ruleset="ep")
    assert "skip" not in rec and rec["n_layers"] == 32 == cfg.n_layers
    assert rec["moe"] == {"experts": 8, "d_ff": 14336,
                          "experts_per_card": 2, "d_ff_per_card": 14336}
    mesh = sharding.abstract_mesh((1, 4), ("data", "model"))
    parts = rec["memory"]["argument_parts"]
    assert parts["parameters"] == _bytes_per_card(cfg, mesh, "ep")
    experts = 32 * 3 * 8 * cfg.d_model * cfg.d_ff * 2
    assert parts["parameters"] < experts / 4 * 1.1
    assert rec["counted"]["kernels"]["moe_gmm"]["calls"] == 32


@pytest.mark.parametrize("ruleset", ["ep", "base"])
def test_moe_gmm_is_counted_on_the_local_shapes(ruleset):
    """granite-moe-3b-a800m's prefill on rank 0 of a 1 x 4 mesh: the
    counted moe_gmm FLOPs and bytes are ``cost.work`` of each layer's
    local buckets, (10, C, d, f) under ``ep`` and (40, C, d, f / 4) under
    ``base``, C the capacity of the global batch."""
    from repro_torch.kernels.moe_gmm import cost
    from repro_torch.models.moe import _capacity
    cfg = get_arch("granite-moe-3b-a800m")
    B, S = 2, 128
    rec = dryrun.lower_cell("granite-moe-3b-a800m",
                            ShapeSpec("p", S, B, "prefill"), tp=4,
                            ruleset=ruleset)
    E_loc, f_loc = (10, cfg.d_ff) if ruleset == "ep" else (40, cfg.d_ff // 4)
    assert (rec["moe"]["experts_per_card"], rec["moe"]["d_ff_per_card"]) == \
        (E_loc, f_loc)
    C = _capacity(B * S, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    flops, nbytes = cost.work(E_loc, C, cfg.d_model, f_loc, True,
                              torch.bfloat16)
    got = rec["counted"]["kernels"]["moe_gmm"]
    assert got["calls"] == cfg.n_layers
    assert got["flops"] == cfg.n_layers * flops
    assert got["bytes"] == cfg.n_layers * nbytes


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


# a cell whose 4-card entry is not the square split (2, 2)
AUTO_MESH_CELL = ("h2o-danube-3-4b", "decode_32k")


def test_cli_auto_mesh_takes_the_preferred_mesh(tmp_path):
    """``--auto-mesh --chips 4``: the record's split and ruleset are
    ``preferred_mesh``'s for 4 cards."""
    from repro_torch.distributed.meshselect import preferred_mesh
    from repro_torch.models.config import SHAPES_BY_NAME
    arch, shape = AUTO_MESH_CELL
    dp, tp, rules = preferred_mesh(get_arch(arch), SHAPES_BY_NAME[shape], 4)
    assert (dp, tp) != (2, 2)
    dryrun.main(["--arch", arch, "--shape", shape, "--auto-mesh", "--chips",
                 "4", "--out", str(tmp_path)])
    (path,) = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert "error" not in rec and "skip" not in rec
    assert rec["mesh_dp_tp"] == [dp, tp] and rec["ruleset"] == rules
    assert rec["chips"] == 4 and path.name == \
        f"{arch}__{shape}__{dryrun.mesh_name(dp, tp, False)}.json"


def test_cli_both_meshes_and_the_roofline_by_pod(tmp_path, capsys):
    """``--both-meshes`` writes each cell on the single mesh and on two
    pods of it; the roofline's ``--pod`` keeps the one, the other or
    both."""
    dryrun.main(["--arch", "h2o-danube-3-4b", "--shape", "decode_32k",
                 "--tp", "2", "--both-meshes", "--out", str(tmp_path)])
    recs = {r["mesh"]: r for r in load_records(str(tmp_path))}
    assert set(recs) == {"1x2xH100", "2x1x2xH100"}
    assert not recs["1x2xH100"]["multi_pod"]
    assert recs["2x1x2xH100"]["multi_pod"]
    assert recs["2x1x2xH100"]["chips"] == 4
    for pod, want in (("pod1", ["1x2xH100"]), ("pod2", ["2x1x2xH100"]),
                      ("both", ["1x2xH100", "2x1x2xH100"])):
        rows = roofline.main(["--dir", str(tmp_path), "--pod", pod])
        assert [r["mesh"] for r in rows] == want
    assert "2x1x2xH100" in capsys.readouterr().out


def test_roofline_pod_filters_skips_and_errors_too(tmp_path, capsys):
    for mp in (False, True):
        dryrun.run_cell("hubert-xlarge", "decode_32k", str(tmp_path), tp=2,
                        multi_pod=mp)
    roofline.main(["--dir", str(tmp_path), "--pod", "pod2"])
    out = capsys.readouterr().out
    assert out.count("hubert-xlarge x decode_32k") == 1


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
