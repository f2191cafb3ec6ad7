"""qwen2-0.5b [dense]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.

GQA kv=2, QKV bias, tied embeddings, rope_theta=1e6 [arXiv:2407.10671].
494,032,768 parameters (1.98 GB in float32).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    skip_shapes=(("long_500k",
                  "full quadratic attention; no sub-quadratic path"),),
))
