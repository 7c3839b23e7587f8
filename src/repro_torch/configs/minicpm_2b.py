"""minicpm-2b — llama-like dense, tied embeddings, WSD schedule
[arXiv:2404.06395; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    attention="full",
    subquadratic=False,          # full attention => skip long_500k
    source="arXiv:2404.06395",
)

# Training-schedule hint for the optimizer (the paper's WSD schedule).
SCHEDULE = "wsd"
