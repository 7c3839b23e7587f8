"""xlstm-1.3b — sLSTM + mLSTM blocks, 1:1 interleave [arXiv:2405.04517]."""
from repro_torch.models.config import ArchConfig, MLSTM, SLSTM

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                      # no separate FFN: gates live inside blocks
    vocab_size=50304,
    block_pattern=(MLSTM, SLSTM),
    subquadratic=True,           # O(1) decode state => runs long_500k
    act="geglu",                 # only used by the sLSTM post-MLP
    source="arXiv:2405.04517",
)
