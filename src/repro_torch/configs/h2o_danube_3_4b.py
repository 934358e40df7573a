"""h2o-danube-3-4b [dense]: 24L, d=3840, 32H (GQA kv=8), d_ff=10240, vocab=32000.
llama+mistral mix with sliding-window attention (window 4096)
[arXiv:2401.16818]. SWA => long_500k eligible."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    num_layers=24, d_model=3840, num_heads=32, num_kv_heads=8,
    d_ff=10240, vocab=32000,
    layer_pattern="L", attn_window=4096,
    supports_long_context=True,
)
