"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8 [hf:ibm-granite/granite-3.0-3b-a800m-base].

Spec-discrepancy note (DESIGN.md): the assignment line says both "MoE 40e
top-8" and "32 experts top-8"; we implement 40 experts / top-8 (the inline
shape spec, which also matches the granite-3.0-3b-a800m card). Every layer is
MoE; expert ffn width is 512 (SwiGLU). Embeddings tied.

40 experts do not divide the 16-way model axis, so the sharder falls back to
tensor-parallel experts (ff 512/16=32 per shard) — see distributed/sharding.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
    skip_shapes=(("long_500k", "full quadratic attention; no sub-quadratic path"),),
))
