"""Multi-head Latent Attention (MLA), DeepSeek-V2 style.

Port of ``repro.models.attention``. Two paths, as in the reference:
  * without a cache: the naive path (decompress c_kv -> k, v per head);
  * with a cache (the engine's prefill into the cache and every decode
    step): the *absorbed* path, where the queries are projected into the
    kv_lora_rank-wide latent space and attention runs against the
    compressed cache (c_kv, k_rope) directly.

No kernel runs here (the reference calls no Pallas kernel for MLA either).
The cache is one layer's {"c_kv": (B, S_max, r), "k_rope": (B, S_max,
rope), "offset": int}; the new entries are written in place at [offset,
offset + S), and the absorbed path reads the first offset + S slots: the
reference masks the others to -1e30 before the softmax, which gives them
probability 0 exactly, so the probabilities are the same.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (NEG_INF, apply_rope, dense,
                                       dense_init, rmsnorm, rmsnorm_init)


def mla_init(gen, cfg: ArchConfig, dtype, lead=()):
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * qk_dim, dtype,
                         lead=lead),
        "wkv_a": dense_init(gen, cfg.d_model,
                            cfg.kv_lora_rank + cfg.qk_rope_dim, dtype,
                            lead=lead),
        "kv_norm": rmsnorm_init(cfg.kv_lora_rank, dtype, gen.device, lead),
        "wkv_b": dense_init(gen, cfg.kv_lora_rank,
                            cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim),
                            dtype, lead=lead),
        "wo": dense_init(gen, cfg.n_heads * cfg.v_head_dim, cfg.d_model,
                         dtype, lead=lead),
    }


def _project_q(p, cfg, x, positions):
    b, s, _ = x.shape
    qk_dim = cfg.qk_nope_dim + cfg.qk_rope_dim
    q = dense(p["wq"], x).reshape(b, s, cfg.n_heads, qk_dim)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _compress_kv(p, cfg, x, positions):
    b, s, _ = x.shape
    kv_a = dense(p["wkv_a"], x)
    c_kv = rmsnorm(p["kv_norm"], kv_a[..., :cfg.kv_lora_rank], cfg.norm_eps)
    k_rope = kv_a[..., cfg.kv_lora_rank:].reshape(b, s, 1, cfg.qk_rope_dim)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope                                   # (B,S,r), (B,S,rope)


def mla_apply(p, cfg: ArchConfig, x, positions, cache=None):
    """x: (B, S, d_model) -> (B, S, d_model); ``cache`` as in the module
    docstring, updated in place."""
    b, s, _ = x.shape
    nope, h = cfg.qk_nope_dim, cfg.n_heads
    scale = 1.0 / math.sqrt(nope + cfg.qk_rope_dim)
    q_nope, q_rope = _project_q(p, cfg, x, positions)
    c_kv, k_rope = _compress_kv(p, cfg, x, positions)

    if cache is None:
        kv = dense(p["wkv_b"], c_kv).reshape(b, s, h, nope + cfg.v_head_dim)
        k_nope, v = kv[..., :nope], kv[..., nope:]
        k_rope_b = k_rope[:, :, None, :].expand(b, s, h, cfg.qk_rope_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope_b], dim=-1)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        qpos = torch.arange(s, device=x.device)
        mask = qpos[:, None] >= qpos[None, :]
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    else:
        offset = cache["offset"]
        c_all, r_all = cache["c_kv"], cache["k_rope"]
        if not isinstance(offset, int) or offset < 0 or \
                offset + s > c_all.shape[1]:
            raise ValueError(f"cache offset {offset!r} + {s} new tokens "
                             f"does not fit a cache of {c_all.shape[1]} "
                             f"slots (the offset must be a host int)")
        c_all[:, offset:offset + s] = c_kv.to(c_all.dtype)
        r_all[:, offset:offset + s] = k_rope.to(r_all.dtype)
        kv_len = offset + s
        c_v, r_v = c_all[:, :kv_len], r_all[:, :kv_len]
        w_b = p["wkv_b"]["w"].reshape(cfg.kv_lora_rank, h,
                                      nope + cfg.v_head_dim)
        w_uk, w_uv = w_b[..., :nope], w_b[..., nope:]     # (r,H,nope), (r,H,v)
        # absorb W_uk into q: (B,S,H,nope) x (r,H,nope) -> (B,S,H,r)
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk.to(q_nope.dtype))
        scores = torch.einsum("bshr,bkr->bhsk", q_lat, c_v.to(q_lat.dtype))
        scores = scores + torch.einsum("bshd,bkd->bhsk", q_rope,
                                       r_v.to(q_rope.dtype))
        scores = scores.float() * scale
        kpos = torch.arange(kv_len, device=x.device)
        qpos = offset + torch.arange(s, device=x.device)
        scores = torch.where(kpos[None, :] <= qpos[:, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhsk,bkr->bshr", probs, c_v.to(probs.dtype))
        out = torch.einsum("bshr,rhd->bshd", ctx, w_uv.to(ctx.dtype))

    out = out.reshape(b, s, h * cfg.v_head_dim)
    return dense(p["wo"], out)


def mla_cache_spec(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16):
    """(shape, dtype) of one layer's compressed cache."""
    return {"c_kv": ((batch, max_len, cfg.kv_lora_rank), dtype),
            "k_rope": ((batch, max_len, cfg.qk_rope_dim), dtype)}
