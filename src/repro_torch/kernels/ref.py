"""Plain PyTorch versions of the ported kernels (the correctness references).

Port of ``repro.kernels.ref``: the attention and packing oracles, and the
Eq. 6, delta-codec and twin-microtick parts, the latter written over a
leading agent axis (the JAX package ``vmap``s a per-agent function). Each function follows the JAX operation
order, so on the CPU it agrees with the JAX oracle to float32 roundoff (and
bit for bit for the codec and the twin). These are what the kernel wrappers
run for CPU tensors, and what ``chip_smoke.py`` holds each CUDA kernel
against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Attention and packing (the LM side)
# ---------------------------------------------------------------------------
def _attend(q, k, v, mask):
    """Softmax attention in float32 from inputs cast to float32; query head
    h reads kv head h // (Hq / Hkv). q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D),
    mask broadcastable to (B, Hq, Sq, Sk) or None. Output in q's type."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def flash_attention_ref(q, k, v, causal=True):
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D). Returns (B, Sq, Hq, D)."""
    sq, sk = q.shape[1], k.shape[1]
    mask = None
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
    return _attend(q, k, v, mask)


def decode_attention_ref(q, k_cache, v_cache, kv_len):
    """q: (B, 1, Hq, D); caches: (B, S_max, Hkv, D); kv_len: an int, or a
    (B,) tensor. Single-query attention over the valid prefix of the
    cache."""
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    if isinstance(kv_len, int):        # no host->device copy
        valid = (kpos < kv_len)[None]                           # (1, S)
    else:
        valid = kpos[None, :] < kv_len.reshape(-1, 1)           # (B, S)
    return _attend(q, k_cache, v_cache, valid[:, None, None, :])


def decode_attention_split_ref(q, k_cache, v_cache, kv_len, bounds):
    """K5's split-KV arithmetic in plain PyTorch (float32): the partials
    (m, l, acc) of each key range [start, end) of ``bounds``, clipped to
    [0, kv_len), then their combine m* = max m_i, w_i = exp(m_i - m*),
    out = sum w_i acc_i / max(sum w_i l_i, 1e-30). A range with no valid
    key has m = -inf, l = 0, acc = 0 and weight exactly 0. q: (B, 1, Hq, D);
    caches: (B, S_max, Hkv, D); kv_len: an int. Returns (B, 1, Hq, D) in
    q's type."""
    rep = q.shape[2] // k_cache.shape[2]
    qf = q[:, 0].float()                                       # (B, Hq, D)
    kf = k_cache.float().repeat_interleave(rep, dim=2)
    vf = v_cache.float().repeat_interleave(rep, dim=2)
    b, hq, d = qf.shape
    ms, ls, accs = [], [], []
    for start, end in bounds:
        end = min(end, kv_len)
        if end <= start:
            ms.append(torch.full((b, hq), -math.inf, device=q.device))
            ls.append(torch.zeros(b, hq, device=q.device))
            accs.append(torch.zeros(b, hq, d, device=q.device))
            continue
        s = torch.einsum("bhd,bkhd->bhk", qf, kf[:, start:end]) \
            / math.sqrt(d)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bhk,bkhd->bhd", p, vf[:, start:end]))
    m = torch.stack(ms)                                     # (n, B, Hq)
    m_star = m.amax(0)
    w = torch.where(m == -math.inf, torch.zeros_like(m),
                    torch.exp(m - m_star))
    l_star = (w * torch.stack(ls)).sum(0)
    out = (w[..., None] * torch.stack(accs)).sum(0) \
        / torch.clamp_min(l_star, 1e-30)[..., None]
    return out[:, None].to(q.dtype)


def flash_attention_bf16p_ref(q, k, v, causal=True):
    """K4's bf16 numerics in plain PyTorch: float32 scores and softmax
    (m the row max, l the float32 sum of p = exp(s - m)), P rounded to bf16
    before P V in float32, out = (P V) / l rounded once to q's type.
    Shapes as ``flash_attention_ref``."""
    sq, sk = q.shape[1], k.shape[1]
    rep = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(q.shape[-1])
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), vf)
    return (o / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]).to(
        q.dtype)


def pack_ref(tokens, indices):
    """tokens: (T, D); indices: (N,) int32 (negative = padding slot -> 0,
    beyond T clipped to T - 1, as the JAX oracle does). The frame/token
    packing gather: out[i] = tokens[indices[i]] or 0."""
    safe = indices.long().clamp(0, tokens.shape[0] - 1)
    out = tokens[safe]
    return torch.where((indices >= 0)[:, None], out,
                       torch.zeros((), dtype=tokens.dtype,
                                   device=tokens.device))


# ---------------------------------------------------------------------------
# Streaming-moment diversity insert (Eq. 6 engine)
# ---------------------------------------------------------------------------


def chol_small(cov, eps=1e-12):
    """Cholesky factors of a batch (A, D, D) of small SPD matrices,
    unrolled over D."""
    d = cov.shape[-1]
    l = torch.zeros_like(cov)
    for j in range(d):
        acc = (l[:, j, :j] * l[:, j, :j]).sum(-1) if j else 0.0
        ljj = torch.sqrt(torch.clamp_min(cov[:, j, j] - acc, eps))
        l[:, j, j] = ljj
        if j + 1 < d:
            dots = ((l[:, j + 1:, :j] * l[:, j, None, :j]).sum(-1)
                    if j else 0.0)
            l[:, j + 1:, j] = (cov[:, j + 1:, j] - dots) / ljj[:, None]
    return l


def tri_solve_small(l, b):
    """Solve L y = b per batch row (L lower-triangular) by forward
    substitution. l: (A, D, D); b: (A, D)."""
    d = l.shape[-1]
    y = torch.zeros_like(b)
    for i in range(d):
        acc = (l[:, i, :i] * y[:, :i]).sum(-1) if i else 0.0
        y[:, i] = (b[:, i] - acc) / l[:, i, i]
    return y


def diversity_score_from_moments(state, probs, s_sum, s_outer, p_sum,
                                 n_filled, *, alpha, beta, ridge=0.1,
                                 eps=1e-8):
    """Eq. 6 score (A,) of one candidate per agent from the running
    sufficient statistics: α·Mahalanobis (cov = E[ssᵀ] − μμᵀ + ridge·I,
    Cholesky + forward solve) + β·KL(probs ‖ p_sum/n)."""
    dim = state.shape[-1]
    n = torch.clamp_min(n_filled.to(torch.float32), 1.0)
    mu = s_sum / n[:, None]
    cov = (s_outer / n[:, None, None] - mu[:, :, None] * mu[:, None, :]
           + ridge * torch.eye(dim, dtype=s_sum.dtype, device=s_sum.device))
    y = tri_solve_small(chol_small(cov), state - mu)
    d_m = torch.sqrt(torch.clamp_min((y * y).sum(-1), 0.0))
    mean_p = torch.where((n_filled > 0)[:, None], p_sum / n[:, None], probs)
    pc = torch.clamp(probs, eps, 1.0)
    qc = torch.clamp(mean_p, eps, 1.0)
    d_kl = (pc * torch.log(pc / qc)).sum(-1)
    return alpha * d_m + beta * d_kl


def _outer(x):
    return x[:, :, None] * x[:, None, :]


def diversity_insert_step(states, probs, score, filled, s_sum, s_outer,
                          p_sum, n_filled, cand_state, cand_probs, *,
                          alpha, beta, ridge=0.1):
    """One streaming insert per agent: score -> slot choice (first empty
    slot, else the min-score slot iff the candidate scores higher) ->
    rank-1 moment update. Returns ((states, probs, score, filled, s_sum,
    s_outer, p_sum, n_filled), (slot, do_insert, score_of_candidate))."""
    ar = torch.arange(score.shape[0], device=score.device)
    d = diversity_score_from_moments(cand_state, cand_probs, s_sum, s_outer,
                                     p_sum, n_filled, alpha=alpha, beta=beta,
                                     ridge=ridge)
    has_empty = ~filled.all(-1)
    empty_idx = torch.argmin(filled.to(torch.int32), dim=-1)
    min_idx = torch.argmin(torch.where(filled, score, torch.inf), dim=-1)
    idx = torch.where(has_empty, empty_idx, min_idx)
    do = has_empty | (d > score[ar, min_idx])

    old_s, old_p = states[ar, idx], probs[ar, idx]
    evict = do & filled[ar, idx]
    add = do.to(s_sum.dtype)[:, None]
    sub = evict.to(s_sum.dtype)[:, None]
    s_sum = s_sum + add * cand_state - sub * old_s
    s_outer = (s_outer + add[..., None] * _outer(cand_state)
               - sub[..., None] * _outer(old_s))
    p_sum = p_sum + add * cand_probs - sub * old_p
    n_filled = n_filled + do.to(n_filled.dtype) - evict.to(n_filled.dtype)

    states, probs = states.clone(), probs.clone()
    score, filled = score.clone(), filled.clone()
    states[ar, idx] = torch.where(do[:, None], cand_state, states[ar, idx])
    probs[ar, idx] = torch.where(do[:, None], cand_probs, probs[ar, idx])
    score[ar, idx] = torch.where(do, d, score[ar, idx])
    filled[ar, idx] = filled[ar, idx] | do
    return ((states, probs, score, filled, s_sum, s_outer, p_sum, n_filled),
            (idx.to(torch.int32), do, d))


def diversity_insert_ref(states, probs, score, filled, s_sum, s_outer, p_sum,
                         n_filled, cand_states, cand_probs, *, alpha, beta,
                         ridge=0.1):
    """Plain version of the K1 ``diversity_insert`` kernel: ingest T
    candidates per agent in order.

    states (A, N, D), probs (A, N, NA), score (A, N), filled (A, N) bool,
    s_sum (A, D), s_outer (A, D, D), p_sum (A, NA), n_filled (A,) int32,
    cand_states (A, T, D), cand_probs (A, T, NA). Returns the updated
    (states, probs, score, filled, s_sum, s_outer, p_sum, n_filled) plus the
    decision trace (slot (A, T) int32, do (A, T) bool, d (A, T)).

    Empty slots hold −inf, so ``argmin(score)`` (lowest index on ties)
    picks the first empty slot if any, else the min-score filled slot, and
    ``d > min(score)`` is the insert test in both regimes. The loop carries
    a per-slot source map (−1 = original occupant, t = candidate t) and
    materializes the slot arrays once at the end."""
    a, n = score.shape
    ar = torch.arange(a, device=score.device)
    score = score.clone()
    src = torch.full((a, n), -1, dtype=torch.long, device=score.device)
    slots, dos, ds = [], [], []
    for t in range(cand_states.shape[1]):
        s, p = cand_states[:, t], cand_probs[:, t]
        d = diversity_score_from_moments(s, p, s_sum, s_outer, p_sum,
                                         n_filled, alpha=alpha, beta=beta,
                                         ridge=ridge)
        minval = score.amin(-1)
        idx = score.argmin(-1)
        do = d > minval                  # -inf (empty slot) accepts always
        evict = do & (minval != -torch.inf)

        si = src[ar, idx]
        from_old = (si < 0)[:, None]
        old_s = torch.where(from_old, states[ar, idx],
                            cand_states[ar, si.clamp_min(0)])
        old_p = torch.where(from_old, probs[ar, idx],
                            cand_probs[ar, si.clamp_min(0)])
        add = do.to(s_sum.dtype)[:, None]
        sub = evict.to(s_sum.dtype)[:, None]
        s_sum = s_sum + add * s - sub * old_s
        s_outer = (s_outer + add[..., None] * _outer(s)
                   - sub[..., None] * _outer(old_s))
        p_sum = p_sum + add * p - sub * old_p
        n_filled = (n_filled + do.to(n_filled.dtype)
                    - evict.to(n_filled.dtype))
        score[ar, idx] = torch.where(do, d, minval)
        src[ar, idx] = torch.where(do, t, si)
        slots.append(idx)
        dos.append(do)
        ds.append(d)

    written = src >= 0
    take = src.clamp_min(0)
    states = torch.where(written[..., None],
                         cand_states[ar[:, None], take], states)
    probs = torch.where(written[..., None], cand_probs[ar[:, None], take],
                        probs)
    return (states, probs, score, filled | written, s_sum, s_outer, p_sum,
            n_filled, torch.stack(slots, 1).to(torch.int32),
            torch.stack(dos, 1), torch.stack(ds, 1))


# ---------------------------------------------------------------------------
# Federated delta codec (error feedback + encode + decode)
# ---------------------------------------------------------------------------
DELTA_CODECS = ("float32", "int8", "topk")


def int8_scale(xf):
    """Per-row symmetric int8 scale (A, 1): max|x|/127 floored away from 0,
    written as a multiply by the reciprocal constant as the reference
    does."""
    return torch.clamp_min(xf.abs().amax(-1, keepdim=True), 1e-12) \
        * (1.0 / 127.0)


def topk_mask(mag, k: int):
    """(A, L) bool mask selecting EXACTLY the k largest entries per row,
    ties broken by lowest index."""
    n = mag.shape[-1]
    if k >= n:
        return torch.ones_like(mag, dtype=torch.bool)
    thresh = torch.sort(mag, dim=-1).values[:, n - k:n - k + 1]
    above = mag > thresh
    n_above = above.sum(-1, keepdim=True)
    eq = mag == thresh
    take_eq = eq & (torch.cumsum(eq.to(torch.int32), dim=-1) <= k - n_above)
    return above | take_eq


def delta_codec_step(xf, *, codec: str, k: int = 1):
    """Encode->decode each row of an error-compensated delta ``xf``.
    Returns (decoded, new_residual) with decoded + new_residual == xf
    (bit-exact for float32/topk, to one ulp of the scale for int8)."""
    if codec == "float32":
        return xf, torch.zeros_like(xf)
    if codec == "int8":
        # residual is (frac - q) * scale, not xf - q*scale: no multiply-add
        # pattern that a compiler could contract
        scale = int8_scale(xf)
        frac = xf / scale
        q = torch.clamp(torch.round(frac), -127.0, 127.0)
        return q * scale, (frac - q) * scale
    if codec == "topk":
        mask = topk_mask(xf.abs(), k)
        return torch.where(mask, xf, 0.0), torch.where(mask, 0.0, xf)
    raise ValueError(f"unknown codec {codec!r}; expected one of {DELTA_CODECS}")


def delta_codec_ref(delta, residual, *, codec: str, k: int = 1):
    """Plain version of the K2 ``delta_codec`` kernel over (A, L) rows."""
    return delta_codec_step(delta + residual, codec=codec, k=k)


# ---------------------------------------------------------------------------
# Request-level twin: one microtick of the five-stage data plane
# ---------------------------------------------------------------------------
# Each agent's in-flight requests occupy a power-of-two ring of arrival
# microticks. Stage occupants are contiguous ring segments between five
# monotone request counters (head <= p_inf <= launch <= p_pre <= tail), so
# ring slot i holds request number q iff q = i (mod R), and admission and
# completion touch the slots with ((i - ptr) & (R-1)) < n.

# counters layout (int32): five stage pointers, the inference server's busy
# flag and completion tick, four request accumulators, the microtick clock
(SIM_TAIL, SIM_PPRE, SIM_LAUNCH, SIM_PINF, SIM_HEAD, SIM_BUSY, SIM_DONE_AT,
 SIM_ARRIVED, SIM_DROPPED, SIM_COMPLETED, SIM_EFFECTIVE, SIM_TICK) = range(12)
SIM_NCOUNTERS = 12

# caps layout (float32; the integer-valued entries are truncated per tick):
# pre/post service per tick, requests per batch, batch service ticks,
# per-stage queue capacity, SLO deadline in ticks
CAP_PRE, CAP_POST, CAP_BATCH, CAP_TBATCH, CAP_QCAP, CAP_SLO = range(6)
SIM_NCAPS = 6


def check_ring(ring: int) -> None:
    if ring <= 0 or ring & (ring - 1):
        raise ValueError(f"ring capacity must be a positive power of two, "
                         f"got {ring}")


def sim_microtick(arrive, counters, credits, lat_sum, hist, n_arrive, caps):
    """One microtick for every agent.

    arrive (A, R) int32, counters (A, SIM_NCOUNTERS) int32, credits (A, 2)
    float32 (pre, post), lat_sum (A,) float32, hist (A, H) int32, n_arrive
    (A,) int32, caps (A, SIM_NCAPS) float32. Returns the new (arrive,
    counters, credits, lat_sum, hist).

    Stages in a backward sweep, so a request spends at least one tick per
    stage: (1) the in-flight batch completes into the post queue; (2) post
    service completes the oldest post-queue requests (latency m + 1 -
    arrive feeds the sum, the effective count and the histogram); (3) a
    work-conserving batch launch, backpressured by post-queue room; (4) pre
    service, backpressured by batch-queue room; (5) admission, dropping
    what the bounded pre queue cannot take. The histogram is a
    ``scatter_add_`` into H+1 buckets whose last (the slots not completed)
    is dropped: the same integers as the reference's (R, H) compare-sum."""
    i32, f32 = torch.int32, torch.float32
    a, ring = arrive.shape
    check_ring(ring)
    hist_n = hist.shape[-1]
    idx = torch.arange(ring, dtype=i32, device=arrive.device)
    c = counters
    m = c[:, SIM_TICK]

    c_pre, c_post = caps[:, CAP_PRE], caps[:, CAP_POST]
    batch_slots = caps[:, CAP_BATCH].to(i32)
    t_batch = caps[:, CAP_TBATCH].to(i32)
    qcap = caps[:, CAP_QCAP].to(i32)
    slo_ticks = caps[:, CAP_SLO].to(i32)

    # (1) inference completion
    done = (c[:, SIM_BUSY] > 0) & (m >= c[:, SIM_DONE_AT])
    p_inf = torch.where(done, c[:, SIM_LAUNCH], c[:, SIM_PINF])
    busy = torch.where(done, 0, c[:, SIM_BUSY])

    # (2) post service (credits stay >= 0: truncation is floor)
    post_credit = torch.minimum(credits[:, 1] + c_post, c_post + 1.0)
    n_post = torch.minimum(post_credit.to(i32), p_inf - c[:, SIM_HEAD])
    post_credit = post_credit - n_post.to(f32)
    comp = ((idx - c[:, SIM_HEAD, None]) & (ring - 1)) < n_post[:, None]
    lat = m[:, None] + 1 - arrive
    lat_sum = lat_sum + torch.where(comp, lat, 0).sum(-1, dtype=i32).to(f32)
    n_eff = (comp & (lat <= slo_ticks[:, None])).sum(-1, dtype=i32)
    bucket = torch.where(comp, lat.clamp(0, hist_n - 1), hist_n)
    counts = torch.zeros(a, hist_n + 1, dtype=i32, device=hist.device)
    counts.scatter_add_(1, bucket.long(), torch.ones_like(bucket))
    hist = hist + counts[:, :hist_n]
    head = c[:, SIM_HEAD] + n_post

    # (3) batch launch, backpressured by post-queue room
    ready = c[:, SIM_PPRE] - c[:, SIM_LAUNCH]
    room = qcap - (c[:, SIM_LAUNCH] - head)
    n_launch = torch.clamp_min(
        torch.minimum(torch.minimum(ready, batch_slots), room), 0)
    do_launch = (busy == 0) & (n_launch > 0)
    launch = torch.where(do_launch, c[:, SIM_LAUNCH] + n_launch,
                         c[:, SIM_LAUNCH])
    done_at = torch.where(do_launch, m + t_batch, c[:, SIM_DONE_AT])
    busy = torch.where(do_launch, 1, busy)

    # (4) pre service, backpressured by batch-queue room
    pre_credit = torch.minimum(credits[:, 0] + c_pre, c_pre + 1.0)
    n_pre = torch.minimum(
        pre_credit.to(i32),
        torch.minimum(c[:, SIM_TAIL] - c[:, SIM_PPRE],
                      torch.clamp_min(qcap - (c[:, SIM_PPRE] - launch), 0)))
    n_pre = torch.clamp_min(n_pre, 0)
    pre_credit = pre_credit - n_pre.to(f32)
    p_pre = c[:, SIM_PPRE] + n_pre

    # (5) admission into the bounded pre queue; overflow drops
    free = torch.minimum(qcap - (c[:, SIM_TAIL] - p_pre),
                         ring - (c[:, SIM_TAIL] - head))
    admit = torch.minimum(torch.clamp_min(torch.minimum(n_arrive, free), 0),
                          n_arrive)
    adm = ((idx - c[:, SIM_TAIL, None]) & (ring - 1)) < admit[:, None]
    arrive = torch.where(adm, m[:, None], arrive)
    tail = c[:, SIM_TAIL] + admit

    counters = torch.stack([
        tail, p_pre, launch, p_inf, head, busy, done_at,
        c[:, SIM_ARRIVED] + n_arrive, c[:, SIM_DROPPED] + (n_arrive - admit),
        c[:, SIM_COMPLETED] + n_post, c[:, SIM_EFFECTIVE] + n_eff, m + 1],
        dim=-1)
    credits = torch.stack([pre_credit, post_credit], dim=-1)
    return arrive, counters, credits, lat_sum, hist


def queue_advance_ref(arrive, counters, credits, lat_sum, hist, arrivals,
                      caps, record: bool = False):
    """Plain version of the K3 ``queue_advance`` kernel: K microticks per
    agent, arrivals (A, K) int32 and one caps row (A, SIM_NCAPS) held for
    the whole control interval. Returns the new (arrive, counters, credits,
    lat_sum, hist), and with ``record`` the counters after each microtick
    stacked, (A, K, SIM_NCOUNTERS) int32, as a sixth; the inputs are not
    modified."""
    state = (arrive, counters, credits, lat_sum, hist)
    ticks = []
    for t in range(arrivals.shape[-1]):
        state = sim_microtick(*state, arrivals[:, t], caps)
        ticks.append(state[1])
    if not record:
        return state
    return (*state, torch.stack(ticks, 1) if ticks else
            counters.new_zeros((counters.shape[0], 0, SIM_NCOUNTERS)))
