"""State-space / recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM + sLSTM).

Port of ``repro.models.ssm``. Each block has a chunkwise-parallel form for
training and prefill and an O(1)-per-token recurrent decode form over an
explicit state cache. ``lax.scan`` over chunks (Mamba2's state passing,
mLSTM's (C, n, m) carry) and over time (sLSTM) becomes a Python loop; the
stabilizers are the reference's. No kernel runs here: the JAX package
computes these recurrences outside Pallas too.

A block's cache is a dict of tensors; the apply functions return the new
state as new tensors (the reference's functional update), so a state's
dtype follows the computation as it does in JAX (a Mamba2 conv window
written into a bf16 cache by a prefill comes back float32 from a float32
decode step).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (NEG_INF, _normal, dense, dense_init,
                                       rmsnorm, rmsnorm_init)


# ===========================================================================
# Mamba2 (scalar-A SSD, n_groups = 1)
# ===========================================================================
def mamba2_init(gen, cfg: ArchConfig, dtype, lead=()):
    """``lead`` prepends stacked axes (zamba2 stacks its Mamba layers)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    dev = gen.device
    conv_ch = di + 2 * n
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * n + h, dtype, lead=lead),
        "conv_w": _normal(gen, (*lead, cfg.d_conv, conv_ch),
                          1.0 / math.sqrt(cfg.d_conv), dtype),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=dev),
        "A_log": torch.zeros((*lead, h), dtype=f32, device=dev),  # A = -1
        "dt_bias": torch.full((*lead, h), math.log(math.e - 1), dtype=f32,
                              device=dev),                   # softplus -> 1
        "D": torch.ones((*lead, h), dtype=f32, device=dev),
        "norm": rmsnorm_init(di, dtype, dev, lead),
        "out_proj": dense_init(gen, di, d, dtype, lead=lead),
    }


def _causal_conv(x, w, b):
    """x: (B, S, C) depthwise causal conv of width K; w: (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b


def _split_mamba(p, cfg, u):
    di, n = cfg.d_inner, cfg.ssm_state
    zxbcdt = dense(p["in_proj"], u)
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def mamba2_apply(p, cfg: ArchConfig, u, cache=None):
    """u: (B, S, d). cache: None or {"h": (B, H, P, N), "conv": (B, K-1,
    C)}. Returns (y, the new cache or None). A multi-token call with a
    cache is a prefill from the empty state (as in the reference)."""
    if cache is not None and u.shape[1] == 1:
        return _mamba2_step(p, cfg, u, cache)
    y, final_state, conv_tail = _mamba2_chunked(
        p, cfg, u, return_state=cache is not None)
    if cache is None:
        return y, None
    return y, {"h": final_state, "conv": conv_tail.to(cache["conv"].dtype)}


def _mamba2_chunked(p, cfg: ArchConfig, u, return_state=False):
    b, s, _ = u.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads
    hd = cfg.ssm_head_dim
    cl = min(cfg.ssm_chunk, s)
    if s % cl:  # pad to a chunk multiple; the tail is sliced off
        assert not return_state, \
            "prefill-with-state requires chunk-multiple seq"
        out, _, _ = _mamba2_chunked(p, cfg, F.pad(u, (0, 0, 0, cl - s % cl)),
                                    False)
        return out[:, :s], None, None
    nc = s // cl
    f32 = torch.float32

    z, xbc_raw, dt = _split_mamba(p, cfg, u)
    xbc = F.silu(_causal_conv(xbc_raw, p["conv_w"].to(u.dtype),
                              p["conv_b"].to(u.dtype)))
    x = xbc[..., :di].reshape(b, s, h, hd)
    B = xbc[..., di:di + n]
    C = xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])                   # (B,S,H)
    a = (-torch.exp(p["A_log"]))[None, None, :] * dt             # (B,S,H)

    xr = (x.float() * dt[..., None]).reshape(b, nc, cl, h, hd)
    Br = B.float().reshape(b, nc, cl, n)
    Cr = C.float().reshape(b, nc, cl, n)
    a_cum = torch.cumsum(a.reshape(b, nc, cl, h), dim=2)         # (b,nc,L,H)

    # intra-chunk (quadratic within a chunk). The upper triangle is masked
    # before the exp, not after as in the reference: the same values, but
    # its exp(+large) never overflows into a 0 * inf = NaN gradient (the
    # reference's gradient is NaN once a chunk's decay passes float32's
    # range, as at full width, chunk 128)
    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=u.device))
    lmat = torch.exp(torch.where(
        tri[None, None, :, :, None],
        a_cum[:, :, :, None, :] - a_cum[:, :, None, :, :], -math.inf))
    cb = torch.einsum("bcln,bcsn->bcls", Cr, Br)
    y_intra = torch.einsum("bclsh,bcshp->bclhp", cb[..., None] * lmat, xr)

    # inter-chunk state passing
    decay_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)           # (b,nc,L,H)
    states = torch.einsum("bcln,bclhp->bchpn", Br,
                          xr * decay_end[..., None])             # (b,nc,H,P,N)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])                  # (b,nc,H)
    carry = torch.zeros((b, h, hd, n), dtype=f32, device=u.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                       # (b,nc,H,P,N)

    y_inter = torch.einsum("bcln,bchpn->bclhp", Cr, prev_states) \
        * torch.exp(a_cum)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, hd)
    y = y + p["D"][None, None, :, None] * x.float()
    y = y.reshape(b, s, di).to(u.dtype)

    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = dense(p["out_proj"], y)
    if not return_state:
        return out, None, None
    conv_tail = xbc_raw[:, s - (cfg.d_conv - 1):, :]  # last K-1 inputs
    return out, carry, conv_tail


def _mamba2_step(p, cfg: ArchConfig, u, cache):
    """Single-token recurrent decode. u: (B, 1, d)."""
    b = u.shape[0]
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_n_heads, \
        cfg.ssm_head_dim
    z, xbc, dt = _split_mamba(p, cfg, u)
    # conv over the cached window (a bf16 window widens, as in JAX)
    wt = torch.promote_types(cache["conv"].dtype, xbc.dtype)
    win = torch.cat([cache["conv"].to(wt), xbc.to(wt)], dim=1)   # (B,K,C)
    xbc1 = F.silu(torch.einsum("bkc,kc->bc", win, p["conv_w"].to(wt))
                  + p["conv_b"].to(wt))
    x = xbc1[:, :di].reshape(b, h, hd).float()
    B = xbc1[:, di:di + n].float()
    C = xbc1[:, di + n:].float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])             # (B,H)
    decay = torch.exp((-torch.exp(p["A_log"]))[None] * dt)       # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, x, B)
    hstate = cache["h"] * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C, hstate) + p["D"][None, :, None] * x
    y = y.reshape(b, 1, di).to(u.dtype)
    y = rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return dense(p["out_proj"], y), {"h": hstate, "conv": win[:, 1:, :]}


def mamba2_cache_spec(cfg: ArchConfig, batch, dtype=torch.bfloat16):
    h, hd, n = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * n
    return {"h": ((batch, h, hd, n), torch.float32),
            "conv": ((batch, cfg.d_conv - 1, conv_ch), dtype)}


# ===========================================================================
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory)
# ===========================================================================
def mlstm_init(gen, cfg: ArchConfig, dtype):
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq": dense_init(gen, d, d, dtype),
        "wk": dense_init(gen, d, d, dtype),
        "wv": dense_init(gen, d, d, dtype),
        "wi": dense_init(gen, d, h, dtype, bias=True),
        "wf": dense_init(gen, d, h, dtype, bias=True),
        "wo_gate": dense_init(gen, d, d, dtype),
        "norm": rmsnorm_init(d, dtype, gen.device),
        "out_proj": dense_init(gen, d, d, dtype),
    }


def mlstm_apply(p, cfg: ArchConfig, x, cache=None):
    """Returns (y, the new {"C", "n", "m"} state or None)."""
    if cache is not None and x.shape[1] == 1:
        return _mlstm_step(p, cfg, x, cache)
    if cache is not None:
        out, (c, n, m) = _mlstm_chunkwise(p, cfg, x, return_state=True)
        return out, {"C": c, "n": n, "m": m}
    if x.shape[1] > cfg.ssm_chunk:
        return _mlstm_chunkwise(p, cfg, x), None
    return _mlstm_parallel(p, cfg, x), None


def _mlstm_qkv_gates(p, cfg, x):
    """q, k / sqrt(dh), v as (B, H, S, dh) and the input / log-forget gates
    as (B, H, S), all float32."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    heads = lambda t: t.reshape(b, s, h, dh).transpose(1, 2)
    q = heads(dense(p["wq"], x)).float()
    k = (heads(dense(p["wk"], x)) / math.sqrt(dh)).float()
    v = heads(dense(p["wv"], x)).float()
    ig = dense(p["wi"], x).float().transpose(1, 2)
    fg = F.logsigmoid(dense(p["wf"], x).float()).transpose(1, 2)
    return q, k, v, ig, fg


def _mlstm_out(p, cfg, x, hs):
    """hs: (B, H, S, dh) float32 -> the block's output."""
    b, s, d = x.shape
    hout = hs.transpose(1, 2).reshape(b, s, d).to(x.dtype)
    hout = rmsnorm(p["norm"], hout, cfg.norm_eps)
    hout = hout * F.silu(dense(p["wo_gate"], x))
    return dense(p["out_proj"], hout)


def _mlstm_parallel(p, cfg: ArchConfig, x):
    """Stabilized quadratic parallel form (xLSTM paper, eqs. 23-27)."""
    s = x.shape[1]
    q, k, v, ig, fg = _mlstm_qkv_gates(p, cfg, x)
    fcum = torch.cumsum(fg, dim=-1)                              # (B,H,S)
    logd = fcum[..., :, None] - fcum[..., None, :] + ig[..., None, :]
    tri = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
    logd = torch.where(tri[None, None], logd, -math.inf)
    m = torch.clamp_min(logd.amax(-1, keepdim=True), NEG_INF)    # (B,H,S,1)
    dmat = torch.exp(logd - m)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * dmat
    norm = torch.maximum(scores.sum(-1, keepdim=True).abs(), torch.exp(-m))
    return _mlstm_out(p, cfg, x,
                      torch.einsum("bhqk,bhkd->bhqd", scores / norm, v))


def _mlstm_chunkwise(p, cfg: ArchConfig, x, return_state=False):
    """Chunkwise-parallel mLSTM: quadratic only within chunks, the matrix
    state (C, n, m) carried across chunks."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    cl = min(cfg.ssm_chunk, s)
    if s % cl:  # pad to a chunk multiple; the tail is sliced off
        assert not return_state, \
            "prefill-with-state requires chunk-multiple seq"
        out = _mlstm_chunkwise(p, cfg, F.pad(x, (0, 0, 0, cl - s % cl)),
                               False)
        return out[:, :s]
    nc = s // cl
    q, k, v, ig, fg = _mlstm_qkv_gates(p, cfg, x)
    qc = q.reshape(b, h, nc, cl, dh)
    kc = k.reshape(b, h, nc, cl, dh)
    vc = v.reshape(b, h, nc, cl, dh)
    igc = ig.reshape(b, h, nc, cl)
    lcum = torch.cumsum(fg.reshape(b, h, nc, cl), dim=-1)
    lsum = lcum[..., -1]                                         # (B,H,nc)

    tri = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=x.device))
    logd = lcum[..., :, None] - lcum[..., None, :] + igc[..., None, :]
    logd = torch.where(tri[None, None, None], logd, -math.inf)
    m_intra = logd.amax(-1)                                      # (B,H,nc,L)
    logw = lsum[..., None] - lcum + igc                          # (B,H,nc,L)
    m_w = logw.amax(-1)                                          # (B,H,nc)
    w_add = torch.exp(logw - m_w[..., None])
    add_c = torch.einsum("bhcld,bhclp->bhcdp", w_add[..., None] * kc, vc)
    add_n = torch.einsum("bhcl,bhcld->bhcd", w_add, kc)

    c_st = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    n_st = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
    m_st = torch.full((b, h), NEG_INF, dtype=torch.float32, device=x.device)
    c_prev, n_prev, m_prev = [], [], []
    for i in range(nc):
        c_prev.append(c_st)
        n_prev.append(n_st)
        m_prev.append(m_st)
        m_new = torch.maximum(lsum[..., i] + m_st, m_w[..., i])
        decay = torch.exp(lsum[..., i] + m_st - m_new)
        sc = torch.exp(m_w[..., i] - m_new)
        c_st = c_st * decay[..., None, None] + sc[..., None, None] \
            * add_c[:, :, i]
        n_st = n_st * decay[..., None] + sc[..., None] * add_n[:, :, i]
        m_st = m_new
    c_prev = torch.stack(c_prev, dim=2)                      # (B,H,nc,dh,dh)
    n_prev = torch.stack(n_prev, dim=2)                          # (B,H,nc,dh)
    m_prev = torch.stack(m_prev, dim=2)                          # (B,H,nc)

    m_inter = lcum + m_prev[..., None]                           # (B,H,nc,L)
    m_i = torch.clamp_min(torch.maximum(m_intra, m_inter), NEG_INF)
    dec_in = torch.exp(m_inter - m_i)
    h_inter = torch.einsum("bhcld,bhcdp->bhclp", qc, c_prev) \
        * dec_in[..., None]
    n_inter = torch.einsum("bhcld,bhcd->bhcl", qc, n_prev) * dec_in
    dmat = torch.exp(logd - m_i[..., None])                      # (B,H,nc,L,L)
    scores = torch.einsum("bhcld,bhcsd->bhcls", qc, kc) * dmat
    h_intra = torch.einsum("bhcls,bhcsp->bhclp", scores, vc)
    n_intra = scores.sum(-1)
    denom = torch.maximum((n_inter + n_intra).abs(),
                          torch.exp(-m_i))[..., None]
    out = _mlstm_out(p, cfg, x,
                     ((h_inter + h_intra) / denom).reshape(b, h, s, dh))
    if return_state:
        return out, (c_st, n_st, m_st)
    return out


def _mlstm_step(p, cfg: ArchConfig, x, cache):
    """Recurrent decode: C <- f C + i k v^T. cache: C (B,H,dh,dh), n
    (B,H,dh), m (B,H)."""
    q, k, v, ig, fg = _mlstm_qkv_gates(p, cfg, x)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]                 # (B,H,dh)
    ig, fg = ig[..., 0], fg[..., 0]                              # (B,H)
    m_new = torch.maximum(fg + cache["m"], ig)
    f_sc = torch.exp(fg + cache["m"] - m_new)[..., None]
    i_sc = torch.exp(ig - m_new)[..., None]
    # the chunkwise form's convention: C[d, p] = sum_j k_d v_p
    c_new = cache["C"] * f_sc[..., None] \
        + i_sc[..., None] * k[..., :, None] * v[..., None, :]
    n_new = cache["n"] * f_sc + i_sc * k
    num = torch.einsum("bhdp,bhd->bhp", c_new, q)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", n_new, q).abs(),
                        torch.exp(-m_new))[..., None]
    return (_mlstm_out(p, cfg, x, (num / den)[:, :, None]),
            {"C": c_new, "n": n_new, "m": m_new})


def mlstm_cache_spec(cfg: ArchConfig, batch):
    h = cfg.n_heads
    dh = cfg.d_model // h
    f32 = torch.float32
    return {"C": ((batch, h, dh, dh), f32), "n": ((batch, h, dh), f32),
            "m": ((batch, h), f32)}


def slstm_init(gen, cfg: ArchConfig, dtype):
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    # input projections of the 4 gates + head-block-diagonal recurrence
    return {
        "w_in": dense_init(gen, d, 4 * d, dtype, bias=True),
        "r": _normal(gen, (4, h, dh, dh), 1.0 / math.sqrt(dh), dtype),
        "norm": rmsnorm_init(d, dtype, gen.device),
        "out_proj": dense_init(gen, d, d, dtype),
    }


def slstm_apply(p, cfg: ArchConfig, x, cache=None):
    """sLSTM with exponential gating and the stabilizer, a loop over time.
    cache: {"c", "n", "h", "m": (B, H, dh)} or None (zeros). Returns (y,
    the final state when a cache was given, else None)."""
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    wx = dense(p["w_in"], x).reshape(b, s, 4, h, dh).float()
    r = p["r"].float()
    if cache is None:
        zeros = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
        st = {"c": zeros, "n": zeros + 1e-6, "h": zeros, "m": zeros}
    else:
        st = cache
    hs = []
    for t in range(s):
        g = wx[:, t] + torch.einsum("bhq,ghpq->bghp", st["h"], r)
        zt = torch.tanh(g[:, 0])
        it, ft = g[:, 1], g[:, 2]
        ot = torch.sigmoid(g[:, 3])
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + st["m"], it)
        i_sc = torch.exp(it - m_new)
        f_sc = torch.exp(log_f + st["m"] - m_new)
        c_new = f_sc * st["c"] + i_sc * zt
        n_new = f_sc * st["n"] + i_sc
        h_new = ot * c_new / torch.clamp_min(n_new, 1e-6)
        st = {"c": c_new, "n": n_new, "h": h_new, "m": m_new}
        hs.append(h_new)
    hout = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    hout = rmsnorm(p["norm"], hout, cfg.norm_eps)
    return dense(p["out_proj"], hout), (st if cache is not None else None)


def slstm_cache_spec(cfg: ArchConfig, batch):
    h = cfg.n_heads
    z = ((batch, h, cfg.d_model // h), torch.float32)
    return {"c": z, "n": z, "h": z, "m": z}
