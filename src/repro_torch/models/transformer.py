"""Transformer assembly for the dense family.

Port of ``repro.models.transformer`` (dense path). The layers are stacked
(a leading L axis on every block parameter, as in the JAX package) and a
Python loop over L takes the place of ``lax.scan``. MoE, MLA, the
first-dense-layers split and the modality frontends are not ported
(ROADMAP queue 1, item 16) and raise ``NotImplementedError``.

The KV cache is a dict {"k", "v": (L, B, S_max, Hkv, D), "offset": int};
the offset is a host int (the reference keeps a scalar int32 array), so a
decode step needs no device->host sync. ``transformer_apply`` writes the
new k/v into the cache tensors in place and returns the cache with the
advanced offset.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (attention_apply, attention_init,
                                       dense, dense_init, embed,
                                       embedding_init, mlp, mlp_init, rmsnorm,
                                       rmsnorm_init, unembed)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unknown dtype {name!r}; expected one of "
                         f"{sorted(DTYPES)}")
    return DTYPES[name]


def check_ported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port's transformer does
    not run yet."""
    missing = []
    if cfg.family != "dense":
        missing.append(f"the {cfg.family} family")
    if cfg.n_experts or cfg.first_dense_layers:
        missing.append("MoE layers")
    if cfg.use_mla:
        missing.append("MLA attention")
    if cfg.frontend != "none":
        missing.append(f"the {cfg.frontend} frontend")
    if cfg.shard_activations:
        missing.append("activation sharding hints")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch yet "
            f"(ROADMAP queue 1, item 16)")


def _block_apply(p, cfg: ArchConfig, x, positions, cache, use_kernels):
    x = x + attention_apply(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps),
                            positions, cache, use_kernels=use_kernels)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h, cfg.act)


def transformer_init(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``gen``'s device: the reference's shapes and
    scales (normal / sqrt(d_in) weights, zero biases and norm gains, the
    embedding at d_model^-1/2), block parameters stacked on a leading L
    axis."""
    check_ported(cfg)
    dtype = torch_dtype(cfg.param_dtype)
    dev = gen.device
    lead = (cfg.n_layers,)
    p: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "blocks": {
            "ln1": rmsnorm_init(cfg.d_model, dtype, dev, lead),
            "ln2": rmsnorm_init(cfg.d_model, dtype, dev, lead),
            "attn": attention_init(gen, cfg, dtype, lead),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                            gated=cfg.mlp_gated, lead=lead),
        },
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    return p


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def transformer_apply(cfg: ArchConfig, params, batch, cache=None,
                      use_kernels=True):
    """Returns (logits, new_cache, aux_dict). ``batch["tokens"]``: (B, S)
    int. ``cache``: None or a cache dict (see the module docstring), whose
    tensors are updated in place."""
    check_ported(cfg)
    scale = float(cfg.d_model) ** 0.5 if cfg.embed_scale else None
    tokens = batch["tokens"]
    x = embed(params["embed"], tokens, scale).to(torch_dtype(cfg.dtype))
    s = x.shape[1]
    offset = 0 if cache is None else cache["offset"]
    positions = torch.arange(s, dtype=torch.int32, device=x.device) + offset

    for i in range(cfg.n_layers):
        layer_cache = None if cache is None else {
            "k": cache["k"][i], "v": cache["v"][i], "offset": offset}
        x = _block_apply(_layer(params["blocks"], i), cfg, x, positions,
                         layer_cache, use_kernels)

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x)
    else:
        logits = dense(params["lm_head"], x)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap

    new_cache = None
    if cache is not None:
        new_cache = {"k": cache["k"], "v": cache["v"], "offset": offset + s}
    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device)}
    return logits, new_cache, aux


def transformer_cache_spec(cfg: ArchConfig, batch, max_len,
                           dtype=torch.bfloat16):
    """{"k", "v": (shape, dtype)} of the stacked cache; its "offset" is a
    host int."""
    check_ported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def new_cache(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16,
              device="cuda"):
    """A zeroed cache with offset 0."""
    spec = transformer_cache_spec(cfg, batch, max_len, dtype)
    cache: Dict[str, Any] = {k: torch.zeros(shape, dtype=dt, device=device)
                             for k, (shape, dt) in spec.items()}
    cache["offset"] = 0
    return cache
