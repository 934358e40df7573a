"""mamba2-130m [ssm]: 24L, d=768, attn-free, vocab=50280, ssm_state=128,
SSD (state-space duality) [arXiv:2405.21060]. O(1) decode state =>
long_500k eligible."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=0, vocab=50280,
    layer_pattern="M", tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2),
    supports_long_context=True,
)
