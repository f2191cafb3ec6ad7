"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (kv=16) d_ff=2816 vocab=151936.

QKV bias, tied embeddings, rope_theta=1e6 [hf:Qwen/Qwen1.5-0.5B].
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    skip_shapes=(("long_500k", "full quadratic attention; no sub-quadratic path"),),
))
