"""hubert-xlarge — encoder-only audio transformer (w2v2 arch); the conv
frontend is a STUB: input_specs() provides precomputed frame embeddings
[arXiv:2106.07447]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,              # masked-prediction cluster labels
    encoder_only=True,
    modality="audio",
    frontend_dim=512,            # conv-frontend output dim (stubbed)
    act="gelu",                  # plain (non-gated) transformer FFN
    subquadratic=False,
    source="arXiv:2106.07447",
)
