"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

Mistral-NeMo-style decoder backbone [hf:mistralai/Pixtral-12B-2409]. The
Pixtral ViT frontend is a STUB per the assignment: ``input_specs`` provides
precomputed 1024-d patch embeddings for n_patches=1024 leading positions
(≈4 images); the model projects them into the sequence ahead of text tokens.
head_dim=128 (q proj 5120 -> 4096).

The patch-resolution bucket is the literal analogue of FCPO's resolution
action for this arch (fewer/more patches per image).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1e6,
    frontend="patches",
    n_patches=1024,
    frontend_dim=1024,
    skip_shapes=(("long_500k", "full quadratic attention; no sub-quadratic path"),),
))
