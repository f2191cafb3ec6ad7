"""Config package: importing it registers every ported architecture."""
from repro_torch.configs.base import (ArchConfig, InputShape, SHAPES,  # noqa: F401
                                      shape_applicable)

# ported architectures (registration side effect)
from repro_torch.configs import (  # noqa: F401
    deepseek_v2_lite,
    gemma_7b,
    granite_moe_3b,
    hubert_xlarge,
    pixtral_12b,
    qwen1p5_0p5b,
    qwen2_0p5b,
    qwen2_7b,
    xlstm_125m,
    zamba2_1p2b,
)

# the JAX package's ARCH_IDS, in its order
ARCH_IDS = [
    "hubert-xlarge",
    "zamba2-1.2b",
    "qwen1.5-0.5b",
    "gemma-7b",
    "qwen2-7b",
    "qwen2-0.5b",
    "granite-moe-3b-a800m",
    "deepseek-v2-lite-16b",
    "pixtral-12b",
    "xlstm-125m",
]
