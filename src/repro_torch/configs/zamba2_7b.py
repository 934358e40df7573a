"""zamba2-7b [hybrid]: 81L, d=3584, 32H (kv=32), d_ff=14336, vocab=32000,
ssm_state=64. Mamba2 backbone with a SHARED full-attention block applied every
6th layer (zamba2's hallmark weight sharing) [arXiv:2411.15242].
SSM-majority => long_500k eligible."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab=32000,
    layer_pattern="MMMMMA",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2),
    supports_long_context=True,
)
