"""deepseek-coder-33b — llama-arch dense, GQA [arXiv:2401.14196; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    attention="full",
    subquadratic=False,
    source="arXiv:2401.14196",
)
