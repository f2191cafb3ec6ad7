"""Hybrid (Zamba2) and xLSTM model assemblies.

Port of ``repro.models.hybrid``.

Zamba2: a Mamba2 backbone with one *weight-shared* attention + MLP block
invoked after every ``attn_every`` Mamba layers (the Zamba signature): 38
layers are 6 groups of 6 plus 2 trailing Mamba layers, and the shared
block runs 6 times with tied weights. Its attention is
``layers.attention_apply``: with ``use_kernels``, K4 ``flash_attention``
in a cache-less forward and K5 ``decode_attention`` in a decode step, as
the reference reaches its Pallas kernels under ``use_pallas``. The Mamba
parameters are stacked on a leading L axis, as the reference's vmapped
init stacks them; a Python loop over the layers takes the place of
``lax.scan``.

xLSTM: mLSTM blocks with an sLSTM block at every ``slstm_every``-th layer
(layers 0 and 8 of xlstm-125m); ``blocks`` is a list, one dict a layer.

Caches. zamba2: {"mamba": {"h": (L, B, H, P, N) float32, "conv": (L, B,
K-1, C)}, "attn": {"k", "v": (G, B, S_max, Hkv, D)}, "offset": int}; the
KV caches are written in place (as the port's transformer writes its
own), the Mamba states come back as new stacked tensors (the reference's
functional update, which lets a state's dtype follow the computation).
xlstm: {"layers": [one state dict a layer], "offset": int}, new states
returned. The offset is a host int, as in ``models/transformer.py``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import ssm
from repro_torch.models.layers import (attention_apply, attention_init,
                                       dense, dense_init, embed,
                                       embedding_init, mlp, mlp_init, rmsnorm,
                                       rmsnorm_init, unembed)
from repro_torch.models.transformer import _layer, maybe_remat, torch_dtype


# ===========================================================================
# Zamba2
# ===========================================================================
def zamba2_init(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    dtype = torch_dtype(cfg.param_dtype)
    dev = gen.device
    lead = (cfg.n_layers,)
    return {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "mamba": {"ln": rmsnorm_init(cfg.d_model, dtype, dev, lead),
                  "mamba": ssm.mamba2_init(gen, cfg, dtype, lead)},
        "shared": {
            "ln1": rmsnorm_init(cfg.d_model, dtype, dev),
            "attn": attention_init(gen, cfg, dtype),
            "ln2": rmsnorm_init(cfg.d_model, dtype, dev),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype),
        },
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
    }  # embeddings tied


def _zamba_groups(cfg: ArchConfig):
    g = cfg.attn_every
    return g, cfg.n_layers // g, cfg.n_layers % g


def zamba2_apply(cfg: ArchConfig, params, batch, cache=None,
                 use_kernels=True, remat=False):
    """Returns (logits, new_cache, {"moe_aux": 0})."""
    x = embed(params["embed"], batch["tokens"]).to(torch_dtype(cfg.dtype))
    s = x.shape[1]
    g, n_groups, trailing = _zamba_groups(cfg)
    offset = 0 if cache is None else cache["offset"]
    positions = torch.arange(s, dtype=torch.int32, device=x.device) + offset
    shared = params["shared"]
    states = []

    def mamba_layer(h, i):
        p_i = _layer(params["mamba"], i)
        c_i = None if cache is None else {
            k: v[i] for k, v in cache["mamba"].items()}

        def body(h):
            y, st = ssm.mamba2_apply(p_i["mamba"], cfg,
                                     rmsnorm(p_i["ln"], h, cfg.norm_eps), c_i)
            return h + y, st
        h, st = maybe_remat(body, remat, h)
        states.append(st)
        return h

    layer = 0
    for gi in range(n_groups):
        for _ in range(g):
            x = mamba_layer(x, layer)
            layer += 1
        a_c = None if cache is None else {
            "k": cache["attn"]["k"][gi], "v": cache["attn"]["v"][gi],
            "offset": offset}
        x = x + attention_apply(shared["attn"], cfg,
                                rmsnorm(shared["ln1"], x, cfg.norm_eps),
                                positions, a_c, use_kernels=use_kernels)
        x = x + mlp(shared["mlp"], rmsnorm(shared["ln2"], x, cfg.norm_eps),
                    cfg.act)
    for _ in range(trailing):
        x = mamba_layer(x, layer)
        layer += 1

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["embed"], x)
    new_cache = None
    if cache is not None:
        new_cache = {"mamba": {k: torch.stack([st[k] for st in states])
                               for k in ("h", "conv")},
                     "attn": cache["attn"], "offset": offset + s}
    return logits, new_cache, {"moe_aux": torch.zeros(
        (), dtype=torch.float32, device=x.device)}


def zamba2_cache_spec(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16):
    """(shape, dtype) of every cache tensor, nested as the cache."""
    _, n_groups, _ = _zamba_groups(cfg)
    m = ssm.mamba2_cache_spec(cfg, batch, dtype)
    kv = ((n_groups, batch, max_len, cfg.n_kv_heads, cfg.head_dim), dtype)
    return {"mamba": {k: ((cfg.n_layers, *shape), dt)
                      for k, (shape, dt) in m.items()},
            "attn": {"k": kv, "v": kv}}


# ===========================================================================
# xLSTM
# ===========================================================================
def _xlstm_kinds(cfg: ArchConfig):
    return ["slstm" if (cfg.slstm_every and i % cfg.slstm_every == 0)
            else "mlstm" for i in range(cfg.n_layers)]


def xlstm_init(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, Any]:
    dtype = torch_dtype(cfg.param_dtype)
    dev = gen.device
    blocks = []
    for kind in _xlstm_kinds(cfg):
        init = ssm.slstm_init if kind == "slstm" else ssm.mlstm_init
        blocks.append({"ln": rmsnorm_init(cfg.d_model, dtype, dev),
                       "cell": init(gen, cfg, dtype)})
    return {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "blocks": blocks,
        "final_norm": rmsnorm_init(cfg.d_model, dtype, dev),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, dtype),
    }


def xlstm_apply(cfg: ArchConfig, params, batch, cache=None,
                use_kernels=True, remat=False):
    """Returns (logits, new_cache, {"moe_aux": 0}). ``use_kernels`` and
    ``remat`` change nothing: no kernel runs here, and the reference
    takes ``remat`` without applying it to these unrolled blocks."""
    x = embed(params["embed"], batch["tokens"]).to(torch_dtype(cfg.dtype))
    new_layers = []
    for i, (kind, bp) in enumerate(zip(_xlstm_kinds(cfg), params["blocks"])):
        cl = None if cache is None else cache["layers"][i]
        h = rmsnorm(bp["ln"], x, cfg.norm_eps)
        cell = ssm.slstm_apply if kind == "slstm" else ssm.mlstm_apply
        y, st = cell(bp["cell"], cfg, h, cl)
        x = x + y
        new_layers.append(st)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = dense(params["lm_head"], x)
    new_cache = None
    if cache is not None:
        new_cache = {"layers": new_layers,
                     "offset": cache["offset"] + x.shape[1]}
    return logits, new_cache, {"moe_aux": torch.zeros(
        (), dtype=torch.float32, device=x.device)}


def xlstm_cache_spec(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16):
    """(shape, dtype) of every cache tensor: all float32, constant in
    ``max_len``."""
    return {"layers": [
        (ssm.slstm_cache_spec if kind == "slstm" else ssm.mlstm_cache_spec)(
            cfg, batch) for kind in _xlstm_kinds(cfg)]}
