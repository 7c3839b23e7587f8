"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8, tiny expert
d_ff [hf:ibm-granite/granite-3.0 family]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,                    # per-expert hidden
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    attention="full",
    subquadratic=False,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
