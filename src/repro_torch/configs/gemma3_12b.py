"""gemma3-12b [dense]: 48L, d=3840, 16H (GQA kv=8), d_ff=15360, vocab=262144.
5:1 local(window 1024):global interleave, 128k context [hf:google/gemma-3].
Local-majority => long_500k eligible (global layers keep the full cache)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8,
    d_ff=15360, vocab=262144,
    layer_pattern="LLLLLG", attn_window=1024,
    supports_long_context=True,
)
