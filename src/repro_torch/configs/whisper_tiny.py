"""whisper-tiny [audio]: 4L enc + 4L dec, d=384, 6H (kv=6), d_ff=1536, vocab=51865.
Enc-dec with conv frontend STUB: input_specs() supplies precomputed 1500-frame
embeddings [arXiv:2212.04356]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="encdec",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab=51865, norm="ln", act="gelu",
    enc_layers=4, enc_seq=1500, rope_theta=10_000.0,
    tie_embeddings=True,
)
