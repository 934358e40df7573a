"""phi-3-vision-4.2b [vlm]: 32L, d=3072, 32H (kv=32), d_ff=8192, vocab=32064.
phi3-mini backbone + CLIP frontend STUB: input_specs() supplies precomputed
patch embeddings [hf:microsoft/Phi-3-vision-128k-instruct]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab=32064, num_patches=256,
)
