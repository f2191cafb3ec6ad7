"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 — Mamba2 backbone + weight-shared attention block
[arXiv:2411.15242].

The shared transformer block (attention + 8192-wide MLP) is invoked every 6
Mamba2 layers with tied weights — the Zamba signature. Embeddings tied.
A simplification of the JAX package, kept: the real model concatenates the original
embedding to the shared block input and uses per-invocation LoRA deltas; we
invoke the shared block directly (identical compute class, minus the small
LoRA matmuls).

SSM decode is O(1)/token, so the long_500k cell runs (sub-quadratic except
the shared block's attention reads over the KV cache, which is linear in
context per decoded token).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    attn_every=6,
    expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
))
