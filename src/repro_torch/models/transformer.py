"""Transformer assembly for the dense / moe / encoder / vlm families.

Port of ``repro.models.transformer``. The layers are stacked (a leading L
axis on every block parameter, as in the JAX package) and a Python loop
over L takes the place of ``lax.scan``. A block's attention is GQA
(``models/layers.py``) or MLA (``models/attention.py``), its feed-forward
a dense MLP or MoE (``models/moe.py``); ``first_dense_layers`` blocks with
a dense MLP come first, unstacked, as the list ``first_blocks``. The
``frames`` frontend (precomputed frame embeddings, HuBERT's mask
embedding) and the ``patches`` frontend (patch embeddings over the first
positions) feed the trunk. The SSM and hybrid families have their own
assembly (``models/hybrid.py``); activation sharding hints are not ported
(ROADMAP queue 1, item 9) and raise ``NotImplementedError``. ``remat``
recomputes each block in the backward pass (``torch.utils.checkpoint``,
the reference's ``jax.checkpoint`` of the layer body).

The cache is a dict of the per-layer entries stacked over the stacked
layers — GQA: {"k", "v": (L, B, S_max, Hkv, D)}, MLA: {"c_kv": (L, B,
S_max, r), "k_rope": (L, B, S_max, rope)} — plus "first", a list of one
unstacked entry per first dense layer, and "offset", a host int (the
reference keeps a scalar int32 array), so a decode step needs no
device->host sync. ``transformer_apply`` writes the new entries into the
cache tensors in place and returns the cache with the advanced offset.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as mla
from repro_torch.models import moe as moe_mod
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
    """Raise ``NotImplementedError`` for what the port's models do not run
    yet."""
    if cfg.shard_activations:
        raise NotImplementedError(
            f"{cfg.name}: activation sharding hints not ported to "
            f"repro_torch yet (ROADMAP queue 1, item 9)")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _block_init(gen, cfg: ArchConfig, dtype, moe: bool, lead=()):
    p = {"ln1": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
         "ln2": rmsnorm_init(cfg.d_model, dtype, gen.device, lead)}
    if cfg.use_mla:
        p["attn"] = mla.mla_init(gen, cfg, dtype, lead)
    else:
        p["attn"] = attention_init(gen, cfg, dtype, lead)
    if moe:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, lead)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                            gated=cfg.mlp_gated, lead=lead)
    return p


def _block_apply(p, cfg: ArchConfig, x, positions, cache, use_kernels):
    """One block; returns (x, the MoE aux loss or None)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        x = x + mla.mla_apply(p["attn"], cfg, h, positions, cache)
    else:
        x = x + attention_apply(p["attn"], cfg, h, positions, cache,
                                use_kernels=use_kernels)
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        m, aux = moe_mod.moe_apply(p["moe"], cfg, h)
        return x + m, aux
    return x + mlp(p["mlp"], h, cfg.act), None


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------
def transformer_init(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    """Random parameters on ``gen``'s device: the reference's shapes and
    scales (normal / sqrt(d_in) weights, zero biases and norm gains, the
    embedding at d_model^-1/2), block parameters stacked on a leading L
    axis. Every leaf is drawn into its own storage, so the peak is the
    parameters themselves."""
    check_ported(cfg)
    dtype = torch_dtype(cfg.param_dtype)
    dev = gen.device
    n_stack = cfg.n_layers - cfg.first_dense_layers
    p: Dict[str, Any] = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "blocks": _block_init(gen, cfg, dtype, cfg.n_experts > 0,
                              (n_stack,)),
    }
    if cfg.first_dense_layers:
        p["first_blocks"] = [_block_init(gen, cfg, dtype, moe=False)
                             for _ in range(cfg.first_dense_layers)]
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype)
    if cfg.frontend == "patches":
        p["patch_proj"] = dense_init(gen, cfg.frontend_dim, cfg.d_model,
                                     dtype)
    if cfg.frontend == "frames":
        p["frame_proj"] = dense_init(gen, cfg.frontend_dim, cfg.d_model,
                                     dtype)
        p["mask_embed"] = torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=dev)
    return p


def maybe_remat(fn, remat, *args):
    """``fn(*args)``, recomputed in the backward pass under ``remat`` (the
    reference's ``jax.checkpoint``) when a gradient is being taken."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _embed_inputs(params, cfg: ArchConfig, batch):
    act = torch_dtype(cfg.dtype)
    if cfg.frontend == "frames":
        x = dense(params["frame_proj"], batch["embeds"].to(act))
        if "mask" in batch:  # HuBERT-style masked prediction
            m = batch["mask"][..., None].to(x.dtype)
            x = x * (1 - m) + params["mask_embed"].to(x.dtype) * m
        return x
    scale = float(cfg.d_model) ** 0.5 if cfg.embed_scale else None
    x = embed(params["embed"], batch["tokens"], scale).to(act)
    if cfg.frontend == "patches" and "patches" in batch:
        pe = dense(params["patch_proj"], batch["patches"].to(x.dtype))
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def transformer_apply(cfg: ArchConfig, params, batch, cache=None,
                      use_kernels=True, remat=False):
    """Returns (logits, new_cache, aux_dict). ``batch``: {"tokens": (B, S)
    int} (the patches frontend may add "patches": (B, n_patches,
    frontend_dim)), or, for the frames frontend, {"embeds": (B, S,
    frontend_dim)} and an optional bool "mask": (B, S). ``cache``: None or
    a cache dict (see the module docstring), whose tensors are updated in
    place. ``aux_dict["moe_aux"]``: the MoE layers' load-balance loss
    summed over the stacked layers and divided by ``n_layers``."""
    check_ported(cfg)
    x = _embed_inputs(params, cfg, batch)
    s = x.shape[1]
    offset = 0 if cache is None else cache["offset"]
    positions = torch.arange(s, dtype=torch.int32, device=x.device) + offset

    for i, block in enumerate(params.get("first_blocks", ())):
        fc = None if cache is None else dict(cache["first"][i],
                                             offset=offset)
        x, _ = _block_apply(block, cfg, x, positions, fc, use_kernels)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    stacked = () if cache is None else [k for k in cache
                                        if k not in ("first", "offset")]
    for i in range(cfg.n_layers - cfg.first_dense_layers):
        layer_cache = None if cache is None else dict(
            {k: cache[k][i] for k in stacked}, offset=offset)
        x, aux = maybe_remat(_block_apply, remat, _layer(params["blocks"], i),
                             cfg, x, positions, layer_cache, use_kernels)
        if aux is not None:
            aux_total = aux_total + aux

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x)
    else:
        logits = dense(params["lm_head"], x)
    if cfg.logit_softcap > 0:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap

    new_cache = None if cache is None else dict(cache, offset=offset + s)
    return logits, new_cache, {"moe_aux": aux_total / max(cfg.n_layers, 1)}


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def transformer_cache_spec(cfg: ArchConfig, batch, max_len,
                           dtype=torch.bfloat16):
    """(shape, dtype) of every cache tensor, nested as the cache; its
    "offset" is a host int."""
    check_ported(cfg)
    if cfg.use_mla:
        per_layer = mla.mla_cache_spec(cfg, batch, max_len, dtype)
    else:
        kv = ((batch, max_len, cfg.n_kv_heads, cfg.head_dim), dtype)
        per_layer = {"k": kv, "v": kv}
    n_stack = cfg.n_layers - cfg.first_dense_layers
    spec: Dict[str, Any] = {k: ((n_stack, *shape), dt)
                            for k, (shape, dt) in per_layer.items()}
    if cfg.first_dense_layers:
        spec["first"] = [dict(per_layer)
                         for _ in range(cfg.first_dense_layers)]
    return spec


def zeros_of_spec(spec, device):
    """Zero tensors of a nested (shape, dtype) spec (dicts and lists)."""
    if isinstance(spec, dict):
        return {k: zeros_of_spec(v, device) for k, v in spec.items()}
    if isinstance(spec, list):
        return [zeros_of_spec(v, device) for v in spec]
    return torch.zeros(spec[0], dtype=spec[1], device=device)


def new_cache(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16,
              device="cuda", cache_spec=transformer_cache_spec):
    """A zeroed cache of ``cache_spec`` (this module's, or
    ``models/hybrid.py``'s) with offset 0."""
    cache = zeros_of_spec(cache_spec(cfg, batch, max_len, dtype), device)
    cache["offset"] = 0
    return cache
