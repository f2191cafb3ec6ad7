"""gemma-7b [dense]: 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.

GeGLU activation, head_dim=256 (q/kv projections are 3072 -> 4096), embedding
scaled by sqrt(d_model), tied embeddings [arXiv:2403.08295].
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="gelu",
    embed_scale=True,
    tie_embeddings=True,
    skip_shapes=(("long_500k", "full quadratic attention; no sub-quadratic path"),),
))
