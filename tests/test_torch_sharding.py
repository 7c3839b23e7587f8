"""The port's sharding rules (``distributed/sharding.py``) and logical axes
(``models.transformer.logical_axes``) against the JAX package's, on the
CPU: every config's axes leaf for leaf, and its specs under the three
rulesets on the (16, 16) and (2, 16, 16) production meshes, equal to
``repro.distributed.sharding.logical_to_specs`` on ``abstract_mesh``
through ``convert._jax_location`` (a scanned leaf's spec without its
leading "layers" entry); the port's versions of ``tests/test_sharding.py``'s
cases; placements on a ``DeviceMesh`` and the production meshes of a fake
process group; the dry run of a cell on a mesh of fake ranks (collective
bytes counted, per-card terms); and every other config's serving on a
one-rank mesh."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as jax_arch
from repro.distributed import sharding as JS
from repro.models import registry as JR
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import mesh as M
from repro_torch.models import registry as R
from repro_torch.models import transformer as tf
from repro_torch.models.config import ShapeSpec
from repro_torch.tree import tree_leaves

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MESH = S.abstract_mesh(*MESHES["16x16"])
MESH3 = S.abstract_mesh(*MESHES["2x16x16"])


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


@functools.lru_cache(maxsize=None)
def _jax_shapes_and_axes(arch):
    return JR.params_and_axes_shapes(jax_arch(arch))


def _jax_flat(tree, leaf_type):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda t: isinstance(t, leaf_type))[0]}


def _unstacked(entry, idx):
    """A JAX leaf's axes or spec as the port's unstacked layer has it."""
    entry = list(entry)
    if idx is not None:           # drop the leading "layers" dim
        assert entry[:1] in ([], [None], ["layers"]), entry
        entry = entry[1:]
    return entry


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_match_jax(arch):
    cfg = get_arch(arch)
    _, jaxes = _jax_shapes_and_axes(arch)
    jflat = _jax_flat(jaxes, tuple)
    params, axes = R.params_and_axes(cfg)
    got = dict(_walk(axes))
    assert set(got) == {path for path, _ in _walk(params)}
    seen = set()
    for path, ax in got.items():
        jpath, idx = convert._jax_location(cfg, path)
        seen.add(jpath)
        assert list(ax) == _unstacked(jflat[jpath], idx), jpath
        assert len(ax) == params_leaf(params, path).dim(), jpath
    assert seen == set(jflat)


def params_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("ruleset", sorted(S.RULESETS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_jax(arch, ruleset, mesh):
    cfg = get_arch(arch)
    shapes, jaxes = _jax_shapes_and_axes(arch)
    jspecs = JS.logical_to_specs(jaxes, shapes, JS.abstract_mesh(
        *MESHES[mesh]), JS.RULESETS[ruleset])
    jflat = _jax_flat(jspecs, P)
    params, axes = R.params_and_axes(cfg)
    specs = S.logical_to_specs(axes, params, S.abstract_mesh(
        *MESHES[mesh]), S.RULESETS[ruleset])
    n = 0
    for path, spec in _walk(specs):
        jpath, idx = convert._jax_location(cfg, path)
        want = _unstacked(jflat[jpath], idx)
        while want and want[-1] is None:
            want.pop()
        assert spec == tuple(want), jpath
        n += 1
    assert n == len(list(_walk(params)))


def test_rulesets_are_the_references():
    assert S.RULESETS == JS.RULESETS


# the port's versions of tests/test_sharding.py's cases
def test_safe_spec_divisibility():
    assert S.safe_spec((4096, 2048), ("data", "model"), MESH) == \
        ("data", "model")
    # 36 not divisible by 16 -> dropped
    assert S.safe_spec((36, 64), ("model", None), MESH) == ()
    assert S.safe_spec((36, 2048), ("model", "model"), MESH) == \
        (None, "model")


def test_safe_spec_dedups_axes():
    assert S.safe_spec((256, 256), ("model", "model"), MESH) == ("model",)


def test_safe_spec_tuple_axes():
    assert S.safe_spec((64,), (("pod", "data"),), MESH3) == \
        (("pod", "data"),)
    assert S.safe_spec((3,), (("pod", "data"),), MESH3) == ()


def test_arch_param_specs_shard_big_matrices():
    cfg = get_arch("deepseek-coder-33b")
    params, axes = R.params_and_axes(cfg)
    specs = S.logical_to_specs(axes, params, MESH, S.RULESETS["base"])
    layer = specs["layers"][0]
    assert layer["mix"]["wq"] == ("data", "model")      # (d, H Dh)
    assert layer["ffn"]["w1"] == ("data", "model")
    assert specs["head"] == ("data", "model")
    for _, spec in _walk(specs):
        used = [a for a in spec if a is not None]
        assert len(set(used)) == len(used)


def test_moe_ep_ruleset_moves_experts_to_model_axis():
    cfg = get_arch("granite-moe-3b-a800m")
    params, axes = R.params_and_axes(cfg)
    base = S.logical_to_specs(axes, params, MESH, S.RULESETS["base"])
    ep = S.logical_to_specs(axes, params, MESH, S.RULESETS["ep"])
    assert base["layers"][0]["ffn"]["w1"] == (None, "data", "model")
    assert "model" not in ep["layers"][0]["ffn"]["w1"][1:]   # f unsharded
    # 40 experts % 16 != 0 and mixtral's 8: no EP on this mesh
    params2, axes2 = R.params_and_axes(get_arch("mixtral-8x7b"))
    ep2 = S.logical_to_specs(axes2, params2, MESH, S.RULESETS["ep"])
    assert ep2["layers"][0]["ffn"]["w1"][:1] in ((), (None,))


def test_batch_specs_use_dp_axes():
    assert S.batch_specs({"tokens": (256, 4096)}, MESH)["tokens"] == \
        ("data",)
    assert S.batch_specs({"tokens": (256, 4096)}, MESH3)["tokens"] == \
        (("pod", "data"),)
    # batch=1 long-context: not divisible -> replicated
    assert S.batch_specs({"tokens": (1, 4096)}, MESH)["tokens"] == ()


def test_cache_specs_unscanned_layout():
    # KV cache: long sequence dim -> sequence-sharded; batch over "data"
    assert S.cache_specs({"k": (128, 4096, 8, 128)}, MESH)["k"] == \
        ("data", "model")
    # a short cache, and recurrent state: the trailing feature dim
    assert S.cache_specs({"k": (128, 1000, 8, 128)}, MESH)["k"] == \
        ("data", None, None, "model")
    assert S.cache_specs({"C": (128, 4, 256, 256)}, MESH)["C"] == \
        ("data", None, None, "model")
    assert S.cache_specs({"m": (128, 4)}, MESH3)["m"] == (("pod", "data"),)


@pytest.mark.parametrize("shape", [(128, 4096, 8, 128), (128, 1000, 8, 128),
                                   (3, 2048, 8, 64), (128, 4, 256, 256),
                                   (128, 4)])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_specs_match_jax_unscanned(shape, mesh):
    jmesh = JS.abstract_mesh(*MESHES[mesh])
    want = JS.cache_specs({"c": jax.ShapeDtypeStruct(shape, np.float32)},
                          jmesh, scanned=False)["c"]
    got = S.cache_specs({"c": shape}, S.abstract_mesh(*MESHES[mesh]))["c"]
    assert got == tuple(want)


@pytest.fixture
def fake_ranks():
    """The default group as rank 0 of 8 fake ranks."""
    with dryrun.fake_group(8):
        yield


def test_placements_and_production_meshes(fake_ranks):
    from torch.distributed.tensor import Replicate, Shard
    mesh = M.make_production_mesh(2, 2, multi_pod=True, device_type="cpu")
    assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert S.mesh_shape(mesh) == {"pod": 2, "data": 2, "model": 2}
    assert S.placements(mesh, ()) == (Replicate(),) * 3
    # one tensor dim over ("pod", "data"), major first
    assert S.placements(mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="mesh's order"):
        S.placements(mesh, (("data", "pod"),))
    t = torch.arange(8 * 6.0).reshape(8, 6)
    d = S.distribute(t, mesh, (("pod", "data"), "model"))
    assert tuple(d.shape) == (8, 6)
    # rank 0 holds the first of 4 row blocks and of 2 column blocks
    assert torch.equal(d.to_local(), t[:2, :3])
    assert M.make_local_mesh(4, device_type="cpu").mesh_dim_names == \
        ("data", "model")
    with pytest.raises(ValueError, match="needs 12 ranks"):
        M.make_production_mesh(3, 4)


def test_a_rank_piece_holds_only_its_own_memory(fake_ranks):
    """A sharded piece is a copy the size of the piece, so that dropping
    the whole tensor frees it (a view would keep the whole model alive on
    every rank); a replicated leaf is the tensor itself, not a copy."""
    mesh = M.make_production_mesh(2, 4, device_type="cpu")
    t = torch.arange(8 * 6.0).reshape(8, 6)
    piece = S.distribute(t, mesh, ("model",)).to_local()
    assert torch.equal(piece, t[:2])
    assert piece.untyped_storage().nbytes() == piece.nbytes == t.nbytes // 4
    assert S.distribute(t, mesh, ()).to_local().data_ptr() == t.data_ptr()
    with pytest.raises(ValueError, match="do not split"):
        M.make_local_mesh(3)


@pytest.fixture
def one_rank():
    """The default group as one gloo rank of this process, and its (1, 1)
    ("data", "model") mesh."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield M.make_local_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m-smoke",
                                  "mixtral-8x7b-smoke",
                                  "recurrentgemma-9b-smoke",
                                  "xlstm-1.3b-smoke",
                                  "llama-3.2-vision-11b-smoke",
                                  "hubert-xlarge-smoke"])
def test_other_configs_do_not_serve_on_a_mesh_yet(arch, one_rank):
    """What this test holds, whatever its name says: each of these
    configs, vision and audio among them, runs ``forward_logits`` and
    ``prefill`` on a one-rank (1, 1) mesh under ``base`` and gives the
    unsharded port's logits and cache (float32, other op order: within
    1e-5).  The name is the one the test had while they were refused on a
    mesh; ``test_torch_sharding_moe``, ``test_torch_sharding_recurrent``
    and ``test_torch_sharding_modal`` hold them on four ranks."""
    cfg = dataclasses.replace(get_arch(arch), dtype="float32")
    params = R.init_params(cfg, 0, device="cpu")
    placed = S.distribute_tree(params, S.logical_to_specs(
        R.logical_axes(cfg), params, one_rank, S.RULESETS["base"]), one_rank)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8), np.int32)}
    if cfg.modality == "audio":
        batch = {"frames": rng.standard_normal((2, 8, cfg.frontend_dim),
                                               np.float32)}
    elif cfg.modality == "vision":
        batch["patches"] = rng.standard_normal(
            (2, cfg.n_patches, cfg.frontend_dim), np.float32)
    dispatch = "gather" if cfg.is_moe else "einsum"
    with torch.no_grad():
        for call in (R.forward_logits, R.prefill):
            want = call(params, cfg, batch, moe_dispatch=dispatch,
                        device="cpu")
            got = call(placed, cfg, batch, moe_dispatch=dispatch,
                       device="cpu", mesh=one_rank)
            if call is R.prefill:
                (want, cache), (got, got_cache) = want, got
                for a, b in zip(tree_leaves(got_cache), tree_leaves(cache)):
                    assert S.is_dtensor(a)
                    torch.testing.assert_close(a.full_tensor(), b, rtol=0,
                                               atol=1e-5)
            torch.testing.assert_close(got.full_tensor(), want, rtol=0,
                                       atol=1e-5)


def test_shard_hint_without_a_mesh_is_the_identity():
    x = torch.randn(2, 3, 4)
    assert tf.shard_hint(x, None, ("batch", None, "model")) is x


def test_dry_run_on_fake_ranks_counts_collectives(tmp_path):
    prefill = dryrun.lower_cell("minicpm-2b-smoke",
                                ShapeSpec("p", 64, 4, "prefill"), tp=4)
    assert prefill["mesh"] == "1x4xH100" and prefill["chips"] == 4
    assert prefill["mesh_dp_tp"] == [1, 4] and prefill["ruleset"] == "base"
    coll = prefill["counted"]["collective_wire_bytes"]
    assert coll and all(b > 0 for b in coll.values())
    assert prefill["roofline"]["collective_s"] > 0
    # the flash kernel once a layer on each card, on its 1 of 4 heads
    cfg = get_arch("minicpm-2b-smoke")
    assert prefill["counted"]["kernels"]["flash_attention"]["calls"] == \
        cfg.n_layers
    one = dryrun.lower_cell("minicpm-2b-smoke",
                            ShapeSpec("p", 64, 4, "prefill"))
    fl = {r["chips"]: r["counted"]["kernels"]["flash_attention"]["flops"]
          for r in (one, prefill)}
    assert fl[4] * 4 == pytest.approx(fl[1])
    assert prefill["memory"]["argument_parts"]["parameters"] < \
        one["memory"]["argument_parts"]["parameters"]
    # decode over a cache of 1024 slots, sequence-sharded: the partial
    # attentions' combine all-reduces
    decode = dryrun.lower_cell("minicpm-2b-smoke",
                               ShapeSpec("d", 1024, 4, "decode"), dp=2,
                               tp=2, multi_pod=True)
    assert decode["mesh"] == "2x2x2xH100" and decode["chips"] == 8
    assert decode["counted"]["collective_calls"]["all-reduce"] > 0
    # training counts its collectives too, and so do an MoE, an RG-LRU, a
    # vision and an audio cell
    train = dryrun.lower_cell("minicpm-2b-smoke",
                              ShapeSpec("t", 64, 4, "train"), tp=2)
    assert "skip" not in train
    assert train["counted"]["collective_calls"]["all-reduce"] > 0
    moe = dryrun.lower_cell("granite-moe-3b-a800m-smoke",
                            ShapeSpec("p", 64, 4, "prefill"), tp=2)
    assert "skip" not in moe
    assert moe["counted"]["collective_calls"]["all-reduce"] > 0
    griffin = dryrun.lower_cell("recurrentgemma-9b-smoke",
                                ShapeSpec("p", 64, 4, "prefill"), tp=2)
    assert "skip" not in griffin
    assert griffin["counted"]["collective_calls"]["reduce-scatter"] > 0
    for arch in ("llama-3.2-vision-11b-smoke", "hubert-xlarge-smoke"):
        rec = dryrun.lower_cell(arch, ShapeSpec("p", 64, 4, "prefill"),
                                tp=2)
        assert "skip" not in rec and "error" not in rec
        assert rec["counted"]["collective_calls"]["all-reduce"] > 0
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_cli_on_a_mesh_and_its_row(tmp_path, capsys):
    dryrun.main(["--arch", "h2o-danube-3-4b", "--shape", "decode_32k",
                 "--tp", "8", "--out", str(tmp_path)])
    (path,) = tmp_path.glob("*.json")
    assert path.name == "h2o-danube-3-4b__decode_32k__1x8xH100.json"
    (row,) = roofline.main(["--dir", str(tmp_path)])
    assert row["mesh"] == "1x8xH100" and row["chips"] == "8"
    assert float(row["collective_s"]) > 0
