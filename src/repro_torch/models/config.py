"""Architecture & shape configuration for the model zoo (PyTorch port).

A copy of ``repro/models/config.py``: the port keeps its own so that it
imports nothing of the JAX package.

Every assigned architecture is expressed as an ``ArchConfig``; the four
assigned input-shape regimes are ``ShapeSpec``s.  Full configs are exercised
only through the dry-run (ShapeDtypeStruct, no allocation); smoke tests use
``reduced()`` variants.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds used by hybrid / pattern-based stacks.
ATTN = "attn"            # global self-attention
SWA = "swa"              # sliding-window self-attention
LOCAL = "local"          # local attention (alias of swa, Griffin-style)
CROSS = "cross"          # cross-attention to modality embeddings (VLM)
MLSTM = "mlstm"          # xLSTM matrix-memory block
SLSTM = "slstm"          # xLSTM scalar-memory block (sequential)
RGLRU = "rglru"          # RG-LRU recurrent block (Griffin / RecurrentGemma)


@dataclass(frozen=True)
class ArchConfig:
    """A transformer-family architecture (dense / MoE / SSM / hybrid)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default: d_model // n_heads
    # Attention flavour for plain decoder stacks ("full" | "swa").
    attention: str = "full"
    window: int = 4096               # sliding-window size when attention == swa
    # Pattern-based stacks (hybrid / xlstm / vlm). Empty => uniform decoder.
    block_pattern: Tuple[str, ...] = ()
    # MoE.
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # Modality / topology extras.
    encoder_only: bool = False       # e.g. hubert — no decode step
    modality: str = "text"           # text | audio | vision
    frontend_dim: int = 0            # stub embedding dim for audio/vision inputs
    n_patches: int = 0               # vision: patches per image
    # Misc.
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "swiglu"              # swiglu | gelu
    dtype: str = "bfloat16"
    remat: str = "full"              # full | dots | none
    # Long-context viability: True iff decode state is O(1) or window-bounded.
    subquadratic: bool = False
    source: str = ""

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if not self.block_pattern:
            kind = SWA if self.attention == "swa" else ATTN
            object.__setattr__(self, "block_pattern", (kind,))

    # -- derived ------------------------------------------------------------
    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_scan_blocks(self) -> int:
        """Number of scanned super-blocks (each = one pattern period)."""
        return self.n_layers // self.pattern_period

    @property
    def n_tail_layers(self) -> int:
        """Layers left over after scanned super-blocks (unrolled at the end)."""
        return self.n_layers % self.pattern_period

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (matches init exactly; used for 6ND)."""
        from repro_torch.models.registry import count_params_analytic
        return count_params_analytic(self)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        period = self.pattern_period
        n_layers = max(2 * period, period)  # >=2 periods exercises scan+tail? keep scan only
        d_model = 64
        n_heads = max(2, min(4, self.n_heads))
        while d_model % n_heads:
            n_heads -= 1
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads if self.name != "xlstm-1.3b" else 32,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            window=64,
            frontend_dim=min(self.frontend_dim, 32) if self.frontend_dim else 0,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            remat="none",
        )


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape regime."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(cfg: ArchConfig):
    """The assigned shape cells that are well-defined for this arch.

    Rules from the assignment: encoder-only archs skip decode shapes;
    ``long_500k`` requires sub-quadratic decode state (SSM / hybrid / SWA).
    """
    out = []
    for s in ALL_SHAPES:
        if cfg.encoder_only and s.kind == "decode":
            continue
        if s is LONG_500K and not cfg.subquadratic:
            continue
        out.append(s)
    return out


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    if cfg.encoder_only and shape.kind == "decode":
        return "encoder-only: no decode step"
    if shape is LONG_500K and not cfg.subquadratic:
        return "full attention: 500k KV cache is quadratic-regime; skipped per assignment"
    return None
