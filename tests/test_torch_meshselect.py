"""The port's mesh selection (``distributed/meshselect.py``) and the sweep
that derives its H100 table (``tools/meshselect_sweep.py``): the
reference's lookup and guards step for step on the reference's own table
at 256 chips, the port's table for 4 and 8 cards valid and chosen as the
sweep chooses, the reference's three cases at H100 sizes, and the sweep's
chooser on records made up for it and on one real (arch, kind) counted on
fake ranks."""
import dataclasses
import importlib.util
import pathlib

import pytest

from repro.configs import get_arch as jax_get_arch
from repro.distributed import meshselect as jax_meshselect
from repro.models.config import SHAPES_BY_NAME as JAX_SHAPES
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.distributed import sharding
from repro_torch.distributed.meshselect import (CARDS_PER_NODE, _PREFERRED,
                                                default_mesh, preferred_mesh,
                                                select_mesh)
from repro_torch.launch.mesh import HBM_BYTES
from repro_torch.models.config import SHAPES_BY_NAME

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "meshselect_sweep", ROOT / "tools" / "meshselect_sweep.py")
sweep = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sweep)

KIND_SHAPE = {"train": "train_4k", "prefill": "prefill_32k",
              "decode": "decode_32k"}
ENTRIES = [(chips, arch, kind, mesh)
           for chips, table in sorted(_PREFERRED.items())
           for (arch, kind), mesh in sorted(table.items())]


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES_BY_NAME))
def test_select_mesh_is_the_references_preferred_mesh(arch, shape):
    """On the reference's table, its 256 chips and its (16, 16) default,
    ``select_mesh`` gives what the reference's ``preferred_mesh`` gives."""
    got = select_mesh(get_arch(arch), SHAPES_BY_NAME[shape],
                      table=jax_meshselect._PREFERRED,
                      chips=jax_meshselect.CHIPS_PER_POD,
                      default=(16, 16, "base"))
    assert got == jax_meshselect.preferred_mesh(jax_get_arch(arch),
                                                JAX_SHAPES[shape])


def test_the_table_covers_a_node_and_the_four_card_cells():
    assert CARDS_PER_NODE == 8 and set(_PREFERRED) == {4, 8}
    assert all(_PREFERRED.values())
    # none of the reference's splits of 256 chips is in it
    assert not {m for t in _PREFERRED.values() for m in t.values()} & \
        set(jax_meshselect._PREFERRED.values())


@pytest.mark.parametrize("chips,arch,kind,mesh", ENTRIES,
                         ids=[f"{c}-{a}-{k}" for c, a, k, _ in ENTRIES])
def test_h100_table_entry_is_valid(chips, arch, kind, mesh):
    cfg = get_arch(arch)
    dp, tp, rules = mesh
    assert dp * tp == chips
    assert (cfg.n_heads * cfg.head_dim) % tp == 0
    assert SHAPES_BY_NAME[KIND_SHAPE[kind]].global_batch % dp == 0
    assert rules in sharding.RULESETS and rules in ("base", "ep")
    if rules == "ep":
        assert cfg.is_moe and cfg.n_experts % tp == 0
    # the guards leave every entry as it is on its kind's shape
    assert preferred_mesh(cfg, SHAPES_BY_NAME[KIND_SHAPE[kind]], chips) == \
        mesh


@pytest.mark.parametrize("chips,want", [(1, (1, 1, "base")),
                                        (2, (2, 1, "base")),
                                        (4, (2, 2, "base")),
                                        (8, (4, 2, "base")),
                                        (256, (16, 16, "base"))])
def test_default_is_the_square_split(chips, want):
    assert default_mesh(chips) == want
    # no table for these cards but 4 and 8: the default is what is left
    cfg = get_arch("hubert-xlarge")
    assert preferred_mesh(cfg, SHAPES_BY_NAME["decode_32k"], chips) == want


@pytest.mark.parametrize("chips", [0, 3, 6, 12])
def test_cards_not_a_power_of_two_raise(chips):
    with pytest.raises(ValueError):
        preferred_mesh(get_arch("minicpm-2b"), SHAPES_BY_NAME["train_4k"],
                       chips)


# the reference's three cases (tests/test_meshselect.py) at H100 sizes
@pytest.mark.parametrize("chips", [4, 8])
def test_table_entries_respect_divisibility(chips):
    for (arch, kind), want in _PREFERRED[chips].items():
        got = preferred_mesh(get_arch(arch), SHAPES_BY_NAME[KIND_SHAPE[kind]],
                             chips)
        assert got == want and got[0] * got[1] == chips
    # an (arch, kind) without an entry gets the square split
    for arch in ARCH_IDS:
        for kind, shape in KIND_SHAPE.items():
            if (arch, kind) not in _PREFERRED[chips]:
                assert preferred_mesh(get_arch(arch), SHAPES_BY_NAME[shape],
                                      chips) == default_mesh(chips)


@pytest.mark.parametrize("chips", [4, 8])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_guard_degrades_dp(chips, arch):
    """long_500k's batch of 1 cannot cover a data axis: dp 1, all the
    cards on "model" (or the square split, where the heads do not divide
    over them)."""
    cfg = get_arch(arch)
    dp, tp, _ = got = preferred_mesh(cfg, SHAPES_BY_NAME["long_500k"], chips)
    if (cfg.n_heads * cfg.head_dim) % chips:
        assert got == default_mesh(chips)
    else:
        assert (dp, tp) == (1, chips)


def test_batch_guard_halves_dp_and_the_head_guard_falls_back():
    cfg = get_arch("minicpm-2b")
    table = {("minicpm-2b", "train"): (8, 1, "base")}
    shape = dataclasses.replace(SHAPES_BY_NAME["train_4k"], global_batch=2)
    assert select_mesh(cfg, shape, table, 8, (4, 2, "base")) == \
        (2, 4, "base")
    # 3 x 30 flattened heads do not split over 4 cards: the default
    odd = dataclasses.replace(cfg, n_heads=3, head_dim=30)
    table = {("minicpm-2b", "train"): (2, 4, "ep")}
    assert select_mesh(odd, SHAPES_BY_NAME["train_4k"], table, 8,
                       (4, 2, "base")) == (4, 2, "base")


@pytest.mark.parametrize("chips", [4, 8])
def test_decode_defaults(chips):
    got = preferred_mesh(get_arch("mixtral-8x7b"),
                         SHAPES_BY_NAME["decode_32k"], chips)
    assert got[0] * got[1] == chips
    assert got == _PREFERRED[chips].get(("mixtral-8x7b", "decode"),
                                        default_mesh(chips))


# the sweep
def test_candidates_are_every_split_and_ep_where_the_experts_divide():
    assert sweep.splits(8) == [(8, 1), (4, 2), (2, 4), (1, 8)]
    assert [c[3:] for c in sweep.candidates("minicpm-2b", "train", 4)] == \
        [(4, 1, "base"), (2, 2, "base"), (1, 4, "base")]
    for arch in ("granite-moe-3b-a800m", "mixtral-8x7b"):
        got = sweep.candidates(arch, "prefill", 8)
        assert len(got) == 8
        assert {c[5] for c in got if c[4] == 8} == {"base", "ep"}


def _record(dp, tp, bound, gb=10.0, ruleset="base", accum=1, **kw):
    rec = {"arch": "a", "shape": "prefill_32k", "kind": "prefill",
           "mesh": f"{dp}x{tp}xH100", "chips": dp * tp,
           "mesh_dp_tp": [dp, tp], "ruleset": ruleset,
           "accum_steps": accum,
           "memory": {"argument_size_in_bytes": int(gb * 1e9) // 2,
                      "temp_size_in_bytes": int(gb * 1e9) // 2},
           "roofline": {"bound_s": bound, "dominant": "memory"}}
    rec.update(kw)
    return rec


def test_chooser_takes_the_least_bound_among_fits():
    recs = [_record(4, 1, 3.0), _record(2, 2, 1.0), _record(1, 4, 2.0)]
    win, second = sweep.choose(recs)
    assert sweep.split_of(win) == (2, 2, "base")
    assert sweep.split_of(second) == (1, 4, "base")


def test_chooser_never_takes_a_record_over_the_card():
    over = HBM_BYTES / 1e9 + 1
    recs = [_record(4, 1, 0.1, gb=over), _record(2, 2, 1.0)]
    win, second = sweep.choose(recs)
    assert sweep.split_of(win) == (2, 2, "base") and second is None
    assert sweep.choose([_record(4, 1, 0.1, gb=over)]) == (None, None)
    assert "none fits" in sweep.why_none([_record(4, 1, 0.1, gb=over)])


def test_chooser_never_takes_a_skip_or_an_error():
    skip = _record(4, 1, 0.1, skip="encoder-only: no decode step")
    error = _record(2, 2, 0.1, error="RuntimeError('x')")
    assert sweep.choose([skip, error]) == (None, None)
    win, _ = sweep.choose([skip, error, _record(1, 4, 5.0)])
    assert sweep.split_of(win) == (1, 4, "base")
    why = sweep.why_none([skip, error])
    assert "encoder-only" in why and "RuntimeError" in why


def test_chooser_ties_go_to_the_smaller_tp_then_to_base():
    recs = [_record(1, 4, 1.0), _record(2, 2, 1.0, ruleset="ep"),
            _record(2, 2, 1.0), _record(4, 1, 1.5)]
    win, second = sweep.choose(recs)
    assert sweep.split_of(win) == (2, 2, "base")
    assert sweep.split_of(second) == (2, 2, "ep")


def test_a_train_candidate_is_its_least_accum_that_fits():
    over = HBM_BYTES / 1e9 + 1
    recs = [_record(2, 2, 0.5, gb=over, accum=1),
            _record(2, 2, 2.0, accum=8), _record(2, 2, 1.0, accum=16),
            _record(4, 1, 1.5, accum=4)]
    win, second = sweep.choose(recs)
    assert sweep.split_of(win) == (4, 1, "base") and win["accum_steps"] == 4
    assert second["accum_steps"] == 8


def test_the_accum_search_skips_what_the_bound_rules_out():
    rec = _record(2, 2, 1.0, accum=1)
    rec["memory"] = {"argument_size_in_bytes": 20e9,
                     "temp_size_in_bytes": 400e9}
    # 20 + 400 / a <= 80 first at a = 8
    assert sweep._next_accum(rec, 128) == 8
    assert sweep._next_accum(rec, 4) is None
    rec["memory"]["argument_size_in_bytes"] = HBM_BYTES
    assert sweep._next_accum(rec, 128) is None


def test_one_prefill_pair_through_the_sweep_gives_its_entry(tmp_path):
    """recurrentgemma-9b's prefill on 4 cards: its three base candidates
    counted on fake ranks, and the choice is the committed entry."""
    arch, kind, chips = "recurrentgemma-9b", "prefill", 4
    recs = sweep.sweep([arch], [kind], [chips], str(tmp_path), jobs=1)
    assert len(recs) == 3 and all("error" not in r for r in recs)
    win, _, why = sweep.results_of(recs)[(arch, kind, chips)]
    assert win is not None, why
    assert sweep.split_of(win) == _PREFERRED[chips][(arch, kind)]
    assert sorted(p.name for p in tmp_path.glob("*.json")) == sorted(
        sweep.record_name(r) + ".json" for r in recs)
