"""Core functional layers: norms, RoPE, embeddings, MLPs, GQA attention.

Port of ``repro.models.layers``. Parameters are plain nested dicts of
tensors in the JAX package's layout: a dense weight is (d_in, d_out) and
applies as ``x @ w`` (no transposition anywhere), an rmsnorm gain is
stored as g with the scale 1 + g.

``attention_apply`` takes ``use_kernels`` (the counterpart of the JAX
package's ``use_pallas``): with it, a cache-less forward goes to K4
``flash_attention`` and a one-token step against the cache to K5
``decode_attention`` (kernels for CUDA tensors, their plain versions for
CPU tensors); a multi-token prefill into the cache goes to ``sdpa``, as in
the reference. Without it every call takes ``sdpa``, or, cache-less under
``attn_impl="chunked"``, ``sdpa_chunked`` (its streaming twin).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -1e30


def _normal(gen, shape, scale, dtype):
    """normal(0, 1) * scale, drawn in float32. Scaled in place, so that a
    float32 leaf (a stack of experts: 19.19 GB in deepseek-v2-lite) never
    holds a temporary of its own size beside it."""
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32).mul_(scale)
    return x if dtype == torch.float32 else x.to(dtype)


def dense_init(gen, d_in, d_out, dtype, bias=False, scale=None, lead=()):
    """A (d_in, d_out) weight (``lead`` prepends stacked axes)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": _normal(gen, (*lead, d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=gen.device)
    return p


def dense(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d, dtype, device, lead=()):
    return {"g": torch.zeros((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["g"].float())).to(x.dtype)


def layernorm_init(d, dtype, device, lead=()):
    return {"g": torch.ones((*lead, d), dtype=dtype, device=device),
            "b": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: (..., S, H, D); positions: (..., S) int. Split-halves rotation
    with the angles in float32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    angles = positions[..., None].float() * freqs          # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------
def mlp_init(gen, d_model, d_ff, dtype, gated=True, lead=()):
    p = {"gate": dense_init(gen, d_model, d_ff, dtype, lead=lead),
         "down": dense_init(gen, d_ff, d_model, dtype, lead=lead)}
    if gated:
        p["up"] = dense_init(gen, d_model, d_ff, dtype, lead=lead)
    return p


def _activate(x, act):
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp(p, x, act="silu"):
    h = _activate(dense(p["gate"], x), act)
    if "up" in p:
        h = h * dense(p["up"], x)
    return dense(p["down"], h)


# ---------------------------------------------------------------------------
# Embeddings / heads
# ---------------------------------------------------------------------------
def embedding_init(gen, vocab, d_model, dtype):
    return {"table": _normal(gen, (vocab, d_model), d_model ** -0.5, dtype)}


def embed(p, tokens, scale=None):
    y = p["table"][tokens]
    if scale is not None:
        y = y * torch.tensor(scale, dtype=y.dtype, device=y.device)
    return y


def unembed(p, x):
    return x @ p["table"].T.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA / MQA / MHA)
# ---------------------------------------------------------------------------
def attention_init(gen, cfg: ArchConfig, dtype, lead=()):
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, dtype,
                         bias=cfg.qkv_bias, lead=lead),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype,
                         bias=cfg.qkv_bias, lead=lead),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype,
                         bias=cfg.qkv_bias, lead=lead),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dtype, lead=lead),
    }


def repeat_kv(k, n_rep):
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def sdpa(q, k, v, *, causal, q_offset=0, kv_len=None, softcap=0.0,
         gqa_impl="repeat"):
    """Reference scaled-dot-product attention.

    q: (B, Sq, Hq, D), k/v: (B, Sk, Hkv, D). ``kv_len`` (an int or a (B,)
    tensor) masks cache slots beyond the valid length; ``q_offset`` is the
    absolute position of q[0] for causal masking against a longer kv.
    ``gqa_impl="grouped"`` contracts the shared kv heads directly instead
    of repeating them G times (identical math). The logits are taken in
    q's type and cast to float32, the softmax is float32, the probabilities
    are cast back to q's type, as in the reference."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    grouped = gqa_impl == "grouped" and g > 1
    if grouped:
        qg = q.reshape(b, sq, hkv, g, d)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() * scale
        expand = lambda m: m[:, None, None, :, :]
    else:
        k = repeat_kv(k, g)
        v = repeat_kv(v, g)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        expand = lambda m: m[:, None, :, :]
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    mask = None
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = (qpos[:, None] >= kpos[None, :])[None]          # (1, Sq, Sk)
    if kv_len is not None:
        kpos = torch.arange(sk, device=q.device)
        if isinstance(kv_len, int):        # no host->device copy
            valid = (kpos < kv_len)[None]                       # (1, Sk)
        else:
            valid = kpos[None, :] < kv_len.reshape(-1, 1)       # (B, Sk)
        vmask = valid[:, None, :]
        mask = vmask if mask is None else (mask & vmask)
    if mask is not None:
        logits = torch.where(expand(mask), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if grouped:
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
        return out.reshape(b, sq, hq, d)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def sdpa_chunked(q, k, v, *, causal, chunk=1024):
    """Flash-style streaming attention: the math of ``sdpa``, but the
    (Sq, Sk) score matrix never materializes. KV is consumed in
    ``chunk``-sized blocks with a running (max, denom, acc) online softmax,
    in float32 throughout; ``Sk`` must be a multiple of the chunk (no
    padding, as in the reference)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    k = repeat_kv(k, hq // hkv)
    v = repeat_kv(v, hq // hkv)
    scale = 1.0 / math.sqrt(d)
    chunk = min(chunk, sk)
    assert sk % chunk == 0, (sk, chunk)
    qf = q.float().transpose(1, 2)                            # (B,H,Sq,D)
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, hq, sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hq, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=torch.float32, device=q.device)
    for start in range(0, sk, chunk):
        ki = kf[:, :, start:start + chunk]
        vi = vf[:, :, start:start + chunk]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, ki) * scale     # (B,H,Sq,C)
        if causal:
            kpos = start + torch.arange(chunk, device=q.device)
            mask = qpos[:, None] >= kpos[None, :]
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        if causal:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vi)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def attention_apply(p, cfg: ArchConfig, x, positions, cache=None,
                    use_kernels=True):
    """Full attention with an optional KV cache (decode).

    ``cache``: None (train / prefill without a cache) or a dict
    {"k", "v": (B, S_max, Hkv, D), "offset": int}, the number of valid
    tokens already in the cache as a host int. The new k/v are written into
    the cache tensors IN PLACE at [offset, offset + S) (the JAX package
    returns updated copies as ``new_kv``; the port saves that memory).
    Returns the attention block's output."""
    b, s, _ = x.shape
    q = dense(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kernel_path = use_kernels and (cache is None or s == 1)
    if kernel_path and cfg.logit_softcap > 0:
        # the kernels (as the Pallas ones) take no softcap; refuse rather
        # than differ from sdpa silently
        raise NotImplementedError(
            f"logit_softcap={cfg.logit_softcap}: the attention kernels do "
            f"not apply a softcap; pass use_kernels=False")

    if cache is None:
        if use_kernels:
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=cfg.causal)
        elif cfg.attn_impl == "chunked":
            out = sdpa_chunked(q, k, v, causal=cfg.causal,
                               chunk=cfg.attn_chunk)
        else:
            out = sdpa(q, k, v, causal=cfg.causal, softcap=cfg.logit_softcap,
                       gqa_impl=cfg.gqa_impl)
    else:
        offset = cache["offset"]
        ck, cv = cache["k"], cache["v"]
        if not isinstance(offset, int) or offset < 0 or \
                offset + s > ck.shape[1]:
            raise ValueError(f"cache offset {offset!r} + {s} new tokens "
                             f"does not fit a cache of {ck.shape[1]} slots "
                             f"(the offset must be a host int)")
        ck[:, offset:offset + s] = k.to(ck.dtype)
        cv[:, offset:offset + s] = v.to(cv.dtype)
        kv_len = offset + s
        if use_kernels and s == 1:
            out = decode_attention(q.contiguous(), ck, cv, kv_len)
        else:
            out = sdpa(q, ck.to(q.dtype), cv.to(q.dtype), causal=True,
                       q_offset=offset, kv_len=kv_len,
                       softcap=cfg.logit_softcap, gqa_impl=cfg.gqa_impl)
    return dense(p["wo"], out.reshape(b, s, cfg.q_dim))
