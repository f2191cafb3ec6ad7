"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.

Encoder-only (same trunk as wav2vec2-XL) [arXiv:2106.07447]. The conv
waveform frontend is a STUB per the assignment: ``input_specs`` provides
precomputed 512-d frame embeddings; the model projects them to d_model and
applies HuBERT-style masked-unit prediction over the 504-unit codebook.

Deviations (documented): RoPE replaces the conv positional embedding (keeps
the compute class identical without a max-length pos table); RMSNorm replaces
LayerNorm; FFN is classic (non-gated) GELU, matching HuBERT's 2-matmul FFN
FLOPs exactly.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    act="gelu",
    mlp_gated=False,
    qkv_bias=True,
    causal=False,
    frontend="frames",
    frontend_dim=512,
    skip_shapes=(
        ("decode_32k", "encoder-only: no autoregressive decode step"),
        ("long_500k", "encoder-only: no decode step"),
    ),
))
