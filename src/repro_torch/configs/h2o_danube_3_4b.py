"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    attention="swa",
    window=4096,
    subquadratic=True,           # SWA: KV bounded => runs long_500k
    source="arXiv:2401.16818",
)
