"""qwen3-moe-235b-a22b [moe]: 94L, d=4096, 64H (GQA kv=4), expert d_ff=1536,
vocab=151936, MoE 128 experts top-8 (fine-grained) [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=1536, vocab=151936,
    moe=MoEConfig(num_experts=128, top_k=8, moe_dff=1536),
)
