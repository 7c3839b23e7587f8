"""Per-(arch x shape) mesh selection on a node of H100s (PyTorch port of
``repro/distributed/meshselect.py``).

The best (dp, tp) split depends on both the architecture (head and expert
divisibility) and the shape (the batch must cover dp).  ``select_mesh`` is
the reference's lookup and guards, with the number of cards a parameter;
``preferred_mesh`` applies it to the port's table for 4 or 8 cards, and
``dryrun --auto-mesh`` consults it.

The reference's table holds splits measured on 256-chip TPU pods; none of
its values is used here.  The port's ``_PREFERRED`` is the output of
``tools/meshselect_sweep.py``: every power-of-two split of the cards (and
the ``ep`` ruleset for the MoE configs) counted by the port's dry run on
fake ranks, the least roofline bound among those whose arguments and
temporaries fit a card's 80 GB.  Its values are predicted by the dry run
on the H100 data sheet's figures (``launch/mesh.py``), not measured.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

from repro_torch.models.config import ArchConfig, ShapeSpec

CARDS_PER_NODE = 8      # an HGX H100 node: the dry run's "1x8xH100"

Mesh = Tuple[int, int, str]

# chips -> (arch, kind) -> (dp, tp, ruleset); kind in {train, prefill,
# decode}.  Each entry is the choice of tools/meshselect_sweep.py, named
# by its record (<arch>__<shape>__<mesh>__<ruleset>_a<accum_steps>) with
# the record's roofline bound_s.  Predicted by the dry run on the H100
# data sheet's figures, not measured.  An (arch, kind) without an entry
# fits no split of the cards (PERF.md §6 says why) and gets the square
# split.
_PREFERRED: Dict[int, Dict[Tuple[str, str], Mesh]] = {
    4: {
        # granite-moe-3b-a800m__decode_32k__1x4xH100__ep_a1, 0.0723097 s
        ("granite-moe-3b-a800m", "decode"): (1, 4, "ep"),
        # granite-moe-3b-a800m__train_4k__2x2xH100__ep_a32, 12.0642 s
        ("granite-moe-3b-a800m", "train"): (2, 2, "ep"),
        # h2o-danube-3-4b__decode_32k__1x4xH100__base_a1, 0.0133629 s
        ("h2o-danube-3-4b", "decode"): (1, 4, "base"),
        # h2o-danube-3-4b__prefill_32k__4x1xH100__base_a1, 2.34509 s
        ("h2o-danube-3-4b", "prefill"): (4, 1, "base"),
        # h2o-danube-3-4b__train_4k__4x1xH100__base_a4, 8.54047 s
        ("h2o-danube-3-4b", "train"): (4, 1, "base"),
        # hubert-xlarge__prefill_32k__4x1xH100__base_a1, 2.63517 s
        ("hubert-xlarge", "prefill"): (4, 1, "base"),
        # hubert-xlarge__train_4k__4x1xH100__base_a1, 4.39782 s
        ("hubert-xlarge", "train"): (4, 1, "base"),
        # llama-3.2-vision-11b__train_4k__4x1xH100__base_a8, 19.787 s
        ("llama-3.2-vision-11b", "train"): (4, 1, "base"),
        # minicpm-2b__train_4k__4x1xH100__base_a4, 8.56258 s
        ("minicpm-2b", "train"): (4, 1, "base"),
        # minitron-8b__train_4k__4x1xH100__base_a8, 14.3195 s
        ("minitron-8b", "train"): (4, 1, "base"),
        # mixtral-8x7b__decode_32k__1x4xH100__ep_a1, 0.0251327 s
        ("mixtral-8x7b", "decode"): (1, 4, "ep"),
        # recurrentgemma-9b__decode_32k__1x4xH100__base_a1, 0.00346157 s
        ("recurrentgemma-9b", "decode"): (1, 4, "base"),
        # recurrentgemma-9b__prefill_32k__4x1xH100__base_a1, 4.52859 s
        ("recurrentgemma-9b", "prefill"): (4, 1, "base"),
        # recurrentgemma-9b__train_4k__4x1xH100__base_a16, 19.2706 s
        ("recurrentgemma-9b", "train"): (4, 1, "base"),
        # xlstm-1.3b__decode_32k__1x4xH100__base_a1, 0.036898 s
        ("xlstm-1.3b", "decode"): (1, 4, "base"),
        # xlstm-1.3b__prefill_32k__2x2xH100__base_a1, 7.44582 s
        ("xlstm-1.3b", "prefill"): (2, 2, "base"),
        # xlstm-1.3b__train_4k__4x1xH100__base_a2, 1221.03 s
        ("xlstm-1.3b", "train"): (4, 1, "base"),
    },
    8: {
        # deepseek-coder-33b__train_4k__8x1xH100__base_a32, 35.0155 s
        ("deepseek-coder-33b", "train"): (8, 1, "base"),
        # granite-moe-3b-a800m__decode_32k__1x8xH100__ep_a1, 0.0364572 s
        ("granite-moe-3b-a800m", "decode"): (1, 8, "ep"),
        # granite-moe-3b-a800m__prefill_32k__4x2xH100__ep_a1, 1.56256 s
        ("granite-moe-3b-a800m", "prefill"): (4, 2, "ep"),
        # granite-moe-3b-a800m__train_4k__4x2xH100__ep_a16, 7.30454 s
        ("granite-moe-3b-a800m", "train"): (4, 2, "ep"),
        # h2o-danube-3-4b__decode_32k__1x8xH100__base_a1, 0.00701345 s
        ("h2o-danube-3-4b", "decode"): (1, 8, "base"),
        # h2o-danube-3-4b__prefill_32k__8x1xH100__base_a1, 1.17254 s
        ("h2o-danube-3-4b", "prefill"): (8, 1, "base"),
        # h2o-danube-3-4b__train_4k__8x1xH100__base_a2, 4.27024 s
        ("h2o-danube-3-4b", "train"): (8, 1, "base"),
        # hubert-xlarge__prefill_32k__8x1xH100__base_a1, 1.31759 s
        ("hubert-xlarge", "prefill"): (8, 1, "base"),
        # hubert-xlarge__train_4k__8x1xH100__base_a1, 2.20284 s
        ("hubert-xlarge", "train"): (8, 1, "base"),
        # llama-3.2-vision-11b__decode_32k__1x8xH100__base_a1, 0.0707877 s
        ("llama-3.2-vision-11b", "decode"): (1, 8, "base"),
        # llama-3.2-vision-11b__prefill_32k__8x1xH100__base_a1, 3.46182 s
        ("llama-3.2-vision-11b", "prefill"): (8, 1, "base"),
        # llama-3.2-vision-11b__train_4k__8x1xH100__base_a4, 9.89351 s
        ("llama-3.2-vision-11b", "train"): (8, 1, "base"),
        # minicpm-2b__prefill_32k__8x1xH100__base_a1, 1.44772 s
        ("minicpm-2b", "prefill"): (8, 1, "base"),
        # minicpm-2b__train_4k__8x1xH100__base_a2, 4.28626 s
        ("minicpm-2b", "train"): (8, 1, "base"),
        # minitron-8b__decode_32k__1x8xH100__base_a1, 0.069624 s
        ("minitron-8b", "decode"): (1, 8, "base"),
        # minitron-8b__prefill_32k__8x1xH100__base_a1, 2.63265 s
        ("minitron-8b", "prefill"): (8, 1, "base"),
        # minitron-8b__train_4k__8x1xH100__base_a4, 7.15977 s
        ("minitron-8b", "train"): (8, 1, "base"),
        # mixtral-8x7b__decode_32k__1x8xH100__ep_a1, 0.0131054 s
        ("mixtral-8x7b", "decode"): (1, 8, "ep"),
        # mixtral-8x7b__prefill_32k__4x2xH100__ep_a1, 15.5649 s
        ("mixtral-8x7b", "prefill"): (4, 2, "ep"),
        # recurrentgemma-9b__decode_32k__1x8xH100__base_a1, 0.00232987 s
        ("recurrentgemma-9b", "decode"): (1, 8, "base"),
        # recurrentgemma-9b__prefill_32k__8x1xH100__base_a1, 2.2643 s
        ("recurrentgemma-9b", "prefill"): (8, 1, "base"),
        # recurrentgemma-9b__train_4k__8x1xH100__base_a4, 9.63532 s
        ("recurrentgemma-9b", "train"): (8, 1, "base"),
        # xlstm-1.3b__decode_32k__1x8xH100__base_a1, 0.019263 s
        ("xlstm-1.3b", "decode"): (1, 8, "base"),
        # xlstm-1.3b__prefill_32k__4x2xH100__base_a1, 4.71271 s
        ("xlstm-1.3b", "prefill"): (4, 2, "base"),
        # xlstm-1.3b__train_4k__8x1xH100__base_a1, 610.53 s
        ("xlstm-1.3b", "train"): (8, 1, "base"),
    },
}


def default_mesh(chips: int) -> Mesh:
    """The square split of ``chips`` cards, as the reference's (16, 16) is
    of 256: (chips // t, t, "base"), t the largest power of two with
    t * t <= chips.  Raises unless ``chips`` is a power of two."""
    if chips < 1 or chips & (chips - 1):
        raise ValueError(f"{chips} cards: a mesh needs a power of two")
    t = 1
    while (2 * t) ** 2 <= chips:
        t *= 2
    return chips // t, t, "base"


def select_mesh(cfg: ArchConfig, shape: ShapeSpec,
                table: Mapping[Tuple[str, str], Mesh], chips: int,
                default: Mesh) -> Mesh:
    """(dp, tp, ruleset) for one cell from ``table``, on ``chips`` cards:
    the reference's ``preferred_mesh`` step for step, its chip count a
    parameter."""
    dp, tp, rules = table.get((cfg.name, shape.kind), default)
    # guard: dp must divide the global batch or sharding degrades to
    # replication (worse than the default mesh)
    while dp > 1 and shape.global_batch % dp:
        dp //= 2
        tp = chips // dp
    if dp * tp != chips:
        tp = chips // dp
    # guard: tp should divide the flattened head dim (always true for the
    # table entries; protects custom configs)
    if (cfg.n_heads * cfg.head_dim) % tp:
        dp, tp, rules = default
    return dp, tp, rules


def preferred_mesh(cfg: ArchConfig, shape: ShapeSpec,
                   chips: int = CARDS_PER_NODE) -> Mesh:
    """(dp, tp, ruleset) for one cell on ``chips`` cards (a power of two):
    the port's table's entry where it has one, else the square split."""
    return select_mesh(cfg, shape, _PREFERRED.get(chips, {}), chips,
                       default_mesh(chips))
