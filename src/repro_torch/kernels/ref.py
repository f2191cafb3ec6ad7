"""Plain PyTorch versions of the ported kernels (the correctness references).

Port of the Eq. 6 and delta-codec halves of ``repro.kernels.ref``, written
over a leading agent axis (the JAX package ``vmap``s a per-agent function).
Each function follows the JAX operation order, so on the CPU it agrees with
the JAX oracle to float32 roundoff (and bit for bit for the codec). These are
what the kernel wrappers run for CPU tensors, and what ``chip_smoke.py``
holds each CUDA kernel against on the card.
"""
from __future__ import annotations

import torch

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
