"""Architecture configuration of the port's LM side.

The port's own copy of ``repro.configs.base``: the same ``ArchConfig``
fields, defaults and ``reduced()``, the same ``InputShape`` grid, and a
registry. Every architecture of the JAX package is registered: the
transformer family (dense, MoE, MLA, the encoder and the VLM), the SSM
family (xlstm-125m) and the hybrid (zamba2-1.2b). ``NOT_PORTED`` names an
architecture of the JAX package that the port cannot run yet (none now):
``get_config`` raises ``NotImplementedError`` for it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention / block options
    qkv_bias: bool = False
    act: str = "silu"  # silu -> SwiGLU, gelu -> GeGLU
    mlp_gated: bool = True  # False -> classic 2-matmul FFN (hubert)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    causal: bool = True  # False -> bidirectional encoder
    logit_softcap: float = 0.0
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scaling

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "global"

    # MLA (deepseek)
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # SSM / hybrid
    ssm_state: int = 0
    attn_every: int = 0
    slstm_every: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256

    # modality frontend stub
    frontend: str = "none"  # none | patches | frames
    n_patches: int = 0
    frontend_dim: int = 0

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # lowering choice of the JAX package (no effect in eager PyTorch)
    scan_layers: bool = True

    # attention implementation: "ref" (sdpa) or "chunked" (sdpa_chunked)
    attn_impl: str = "ref"
    attn_chunk: int = 1024

    ce_impl: str = "gather"
    shard_activations: bool = False

    # GQA reference path: "repeat" materializes kv heads G x; "grouped"
    # contracts against the shared kv heads directly (identical math)
    gqa_impl: str = "repeat"

    skip_shapes: Tuple[Tuple[str, str], ...] = ()

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test-sized variant of the same family (same code paths)."""
        kw = dict(
            n_layers=min(self.n_layers,
                         2 if self.attn_every == 0 else self.attn_every + 1),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2)
            if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=min(self.vocab_size, 512),
            dtype="float32",
            param_dtype="float32",
        )
        if self.n_experts:
            kw.update(n_experts=min(self.n_experts, 8),
                      top_k=min(self.top_k, 2), moe_d_ff=64,
                      first_dense_layers=min(self.first_dense_layers, 1),
                      n_shared_experts=min(self.n_shared_experts, 1))
        if self.use_mla:
            kw.update(kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32,
                      v_head_dim=32, head_dim=48)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=32)
        if self.attn_every:
            kw.update(attn_every=2, n_layers=5)
        if self.slstm_every:
            kw.update(slstm_every=2, n_layers=4)
        if self.frontend == "patches":
            kw.update(n_patches=8, frontend_dim=64)
        if self.frontend == "frames":
            kw.update(frontend_dim=64)
        return self.replace(**kw)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape_name: str) -> Tuple[bool, str]:
    """Return (applicable, reason-if-not) for an (arch, shape) cell."""
    for name, reason in cfg.skip_shapes:
        if name == shape_name:
            return False, reason
    return True, ""


# The JAX package's architectures the port cannot run yet: name -> family.
NOT_PORTED: dict = {}

_REGISTRY = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def _load():
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers every config)


def get_config(name: str) -> ArchConfig:
    _load()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name} ({NOT_PORTED[name]} family) is not ported to repro_torch "
            f"yet (ROADMAP queue 1, item 9); ported: {list_archs()}")
    raise KeyError(f"unknown architecture {name!r}; ported: {list_archs()}")


def list_archs():
    _load()
    return sorted(_REGISTRY)
