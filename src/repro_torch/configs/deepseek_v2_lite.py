"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(moe)=1408
vocab=102400, MLA kv_lora=512, 64 routed experts top-6 + 2 shared
[arXiv:2405.04434].

Spec-discrepancy note (DESIGN.md): the assignment line says both "MoE 64e
top-6" and "2 shared+160 routed"; 160 routed is DeepSeek-V2-*full* — the Lite
model is 64 routed + 2 shared top-6, which we implement (consistent with
"MoE 64e top-6"). First layer is dense (d_ff=10944) per the HF config; the
remaining 26 are MoE. MLA: kv_lora_rank=512, qk_nope=128, qk_rope=64,
v_head=128 — decode runs the *absorbed* path against the compressed
(c_kv, k_rope) cache (576 B/token/layer vs 4096 for GQA).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,  # qk_nope + qk_rope
    d_ff=10944,    # first dense layer width (HF config)
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    skip_shapes=(("long_500k", "MLA is still quadratic attention"),),
))
