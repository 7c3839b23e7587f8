"""minitron-8b — pruned Nemotron-4 (squared-ReLU non-gated MLP, 256k vocab)
[arXiv:2407.14679; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    attention="full",
    act="relu2",                 # Nemotron squared-ReLU, non-gated
    subquadratic=False,
    source="arXiv:2407.14679",
)
