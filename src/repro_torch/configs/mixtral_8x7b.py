"""mixtral-8x7b — 8 experts top-2, sliding-window attention
[arXiv:2401.04088; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,                  # per-expert hidden
    vocab_size=32000,
    n_experts=8,
    top_k=2,
    attention="swa",
    window=4096,
    subquadratic=True,           # SWA: KV bounded => runs long_500k
    source="arXiv:2401.04088",
)
