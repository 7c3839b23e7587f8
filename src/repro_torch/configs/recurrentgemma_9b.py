"""recurrentgemma-9b — Griffin: RG-LRU + local attention, 2 recurrent : 1
local-attn; MQA (kv=1) [arXiv:2402.19427]."""
from repro_torch.models.config import ArchConfig, RGLRU, LOCAL

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,                 # 12 (rglru,rglru,local) periods + 2 tail
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=(RGLRU, RGLRU, LOCAL),
    window=2048,                 # local-attention window
    act="geglu",
    subquadratic=True,           # bounded state => runs long_500k
    source="arXiv:2402.19427",
)
