"""llama-3.2-vision-11b — decoder with gated cross-attention image layers
every 5th block; vision tower is a STUB providing patch embeddings
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.models.config import ArchConfig, ATTN, CROSS

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    block_pattern=(ATTN, ATTN, ATTN, ATTN, CROSS),
    modality="vision",
    frontend_dim=1280,           # ViT-H patch-embedding dim (stubbed)
    n_patches=1600,              # (448/14)^2 global + tiles, rounded
    subquadratic=False,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
