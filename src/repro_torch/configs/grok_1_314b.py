"""grok-1-314b [moe]: 64L, d=6144, 48H (GQA kv=8), d_ff=32768, vocab=131072,
MoE 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab=131072,
    moe=MoEConfig(num_experts=8, top_k=2, moe_dff=32768),
)
