"""Diversity-aware fixed-size experience buffer (Eq. 6, §IV-C), stacked.

Port of ``repro.core.buffer``: ``d = α·D_M +
β·D_KL`` — the Mahalanobis novelty of a new state against the stored
states plus the KL divergence of its policy from the buffer's mean policy.
N fixed slots per agent; a new experience replaces the lowest-diversity
slot iff it scores higher (until the buffer is full, it always inserts).

Two scoring engines share those eviction semantics:

  * **Streaming moments** (``buffer_insert_batch`` / ``buffer_insert``):
    the buffer carries running sufficient statistics (state sum,
    outer-product sum, probs sum, filled count), rank-1 updated on every
    insert/evict, so Eq. 6 is O(D²) per candidate. A batch of T
    candidates per agent goes through the K1 ``diversity_insert`` kernel
    for CUDA tensors (``buffer_insert``: T=1) and its plain version for
    CPU tensors; the non-scored payload is then scattered by last writer
    per slot.
  * **Recompute oracle** (``buffer_insert_reference``, with
    ``diversity``, ``mahalanobis`` and ``kl_divergence``): one candidate
    per agent, the covariance rebuilt from the N stored slots and solved
    densely (``torch.linalg.solve``, an LU solve as the reference's
    ``jnp.linalg.solve``). Its decisions equal the streaming engine's
    except at near-ties (ROADMAP queue 3).

Storage dtypes (``core/dtypes.py``, the policy's ``buffer`` family): the
payload may be stored bf16, or int8 states/probs at fixed scales with bf16
logp/rewards/values. Every entry point reads the payload up to float32,
runs the float32 math (K1 takes float32 only) and packs the result back;
the scores and the streaming moments stay float32 under every policy.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from repro_torch import resolve_device
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core import dtypes as dtp
from repro_torch.kernels.diversity import diversity_insert

RIDGE = 0.1  # ε·I covariance regularizer (keeps D_M defined before fill-up)


@dataclass
class DiversityBuffer:
    """Per-agent buffers, leading axis A on every field."""
    states: torch.Tensor    # (A, N, 8)
    actions: torch.Tensor   # (A, N, 3) long
    logp: torch.Tensor      # (A, N)
    rewards: torch.Tensor   # (A, N)
    values: torch.Tensor    # (A, N)
    probs: torch.Tensor     # (A, N, n_res+n_bs+n_mt) policy at insert time
    score: torch.Tensor     # (A, N) stored diversity score (-inf = empty)
    filled: torch.Tensor    # (A, N) bool
    count: torch.Tensor     # (A,) int32 total insertions attempted
    s_sum: torch.Tensor     # (A, 8)    Σ s over filled slots
    s_outer: torch.Tensor   # (A, 8, 8) Σ s sᵀ
    p_sum: torch.Tensor     # (A, NA)   Σ probs
    n_filled: torch.Tensor  # (A,) int32 number of filled slots

    def replace(self, **kw) -> "DiversityBuffer":
        vals = {f.name: getattr(self, f.name) for f in fields(self)}
        vals.update(kw)
        return DiversityBuffer(**vals)


def buffer_init(cfg: FCPOConfig, n_agents: int, device="cuda"
                ) -> DiversityBuffer:
    dev = resolve_device(device)
    a, n, d = n_agents, cfg.buffer_size, cfg.state_dim
    na = cfg.n_res + cfg.n_bs + cfg.n_mt
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=dev)
    return DiversityBuffer(
        states=z(a, n, d), actions=z(a, n, 3, dt=torch.long),
        logp=z(a, n), rewards=z(a, n), values=z(a, n),
        probs=torch.full((a, n, na), 1.0 / na, device=dev),
        score=torch.full((a, n), -torch.inf, device=dev),
        filled=z(a, n, dt=torch.bool), count=z(a, dt=torch.int32),
        s_sum=z(a, d), s_outer=z(a, d, d), p_sum=z(a, na),
        n_filled=z(a, dt=torch.int32))


_F32_PAYLOAD = ("logp", "rewards", "values")


def _payload_f32(buf: DiversityBuffer) -> DiversityBuffer:
    """The stored payload read up to float32 (int8 slots dequantized); the
    identity on a float32 buffer."""
    if buf.states.dtype == torch.int8:
        states = dtp.dequant8(buf.states, dtp.STATE_SCALE)
        probs = dtp.dequant8(buf.probs, dtp.PROB_SCALE)
    else:
        states, probs = buf.states.float(), buf.probs.float()
    return buf.replace(states=states, probs=probs,
                       **{k: getattr(buf, k).float() for k in _F32_PAYLOAD})


def _payload_like(buf: DiversityBuffer, like: DiversityBuffer
                  ) -> DiversityBuffer:
    """A float32-payload buffer packed back to ``like``'s storage dtypes."""
    if like.states.dtype == torch.int8:
        states = dtp.quant8(buf.states, dtp.STATE_SCALE)
        probs = dtp.quant8(buf.probs, dtp.PROB_SCALE)
    else:
        states = buf.states.to(like.states.dtype)
        probs = buf.probs.to(like.probs.dtype)
    return buf.replace(states=states, probs=probs,
                       **{k: getattr(buf, k).to(getattr(like, k).dtype)
                          for k in _F32_PAYLOAD})


def buffer_cast(buf: DiversityBuffer, dtype: str) -> DiversityBuffer:
    """The stored payload cast to a policy's ``buffer`` dtype: ``float32``,
    ``bfloat16`` (all five payload arrays) or ``int8`` (fixed-scale
    states/probs, bf16 logp/rewards/values)."""
    f32 = _payload_f32(buf)
    bf = torch.bfloat16
    if dtype == "float32":
        return f32
    if dtype == "bfloat16":
        return f32.replace(states=f32.states.to(bf), probs=f32.probs.to(bf),
                           **{k: getattr(f32, k).to(bf)
                              for k in _F32_PAYLOAD})
    if dtype == "int8":
        return f32.replace(
            states=dtp.quant8(f32.states, dtp.STATE_SCALE),
            probs=dtp.quant8(f32.probs, dtp.PROB_SCALE),
            **{k: getattr(f32, k).to(bf) for k in _F32_PAYLOAD})
    raise ValueError(f"unknown buffer storage dtype {dtype!r}")


def mahalanobis(state, states, filled):
    """Recompute-oracle D_M per agent: ``state`` (A, D) against the filled
    subset of ``states`` (A, N, D) (``filled`` (A, N)), with a regularized
    covariance (ε·I keeps it defined before the buffer fills). (A,)."""
    w = filled.to(torch.float32)[..., None]
    n = torch.clamp_min(w.sum(1), 1.0)                        # (A, 1)
    mu = (states * w).sum(1) / n
    diff_all = (states - mu[:, None]) * w
    eye = torch.eye(state.shape[-1], device=state.device)
    cov = diff_all.transpose(1, 2) @ diff_all / n[..., None] + RIDGE * eye
    diff = state - mu
    sol = torch.linalg.solve(cov, diff)
    return torch.sqrt(torch.clamp_min((diff * sol).sum(-1), 0.0))


def kl_divergence(p, q, eps=1e-8):
    p = torch.clamp(p, eps, 1.0)
    q = torch.clamp(q, eps, 1.0)
    return (p * torch.log(p / q)).sum(-1)


def diversity(cfg: FCPOConfig, buf: DiversityBuffer, state, probs):
    """Eq. 6 per agent for one candidate each (``state`` (A, D), ``probs``
    (A, NA)), recompute oracle: the covariance and the mean policy rebuilt
    from the N stored slots (read up to float32). (A,)."""
    buf = _payload_f32(buf)
    d_m = mahalanobis(state, buf.states, buf.filled)
    w = buf.filled.to(torch.float32)
    cnt = w.sum(-1)
    mean_probs = ((buf.probs * w[..., None]).sum(1)
                  / torch.clamp_min(cnt, 1.0)[:, None])
    mean_probs = torch.where((cnt > 0)[:, None], mean_probs, probs)
    return cfg.alpha * d_m + cfg.beta * kl_divergence(probs, mean_probs)


def buffer_insert(cfg: FCPOConfig, buf: DiversityBuffer, state, action,
                  logp, reward, value, probs) -> DiversityBuffer:
    """Streaming-moment insert of one candidate per agent (``state`` (A,
    D), ``action`` (A, 3), ``logp`` / ``reward`` / ``value`` (A,),
    ``probs`` (A, NA)): ``buffer_insert_batch`` at T=1, one K1 launch for
    CUDA tensors."""
    return buffer_insert_batch(cfg, buf, *(x[:, None] for x in (
        state, action, logp, reward, value, probs)))


def buffer_insert_reference(cfg: FCPOConfig, buf: DiversityBuffer, state,
                            action, logp, reward, value, probs
                            ) -> DiversityBuffer:
    """The recompute-everything insert (the equivalence oracle) of one
    candidate per agent, arguments as ``buffer_insert``'s: Eq. 6 from
    ``diversity``, then the first empty slot, else the min-score slot iff
    the candidate scores higher. Keeps the streaming moments too, so that
    its buffers stay valid inputs of the streaming engine."""
    stored, buf = buf, _payload_f32(buf)
    state, probs = state.float(), probs.float()
    d = diversity(cfg, buf, state, probs)
    ar = torch.arange(d.shape[0], device=d.device)
    has_empty = ~buf.filled.all(-1)
    empty_idx = torch.argmin(buf.filled.to(torch.int32), dim=-1)
    min_idx = torch.argmin(torch.where(buf.filled, buf.score, torch.inf),
                           dim=-1)
    idx = torch.where(has_empty, empty_idx, min_idx)
    do = has_empty | (d > buf.score[ar, min_idx])

    old_s, old_p = buf.states[ar, idx], buf.probs[ar, idx]
    evict = do & buf.filled[ar, idx]
    add = do.to(torch.float32)[:, None]
    sub = evict.to(torch.float32)[:, None]
    outer = lambda x: x[:, :, None] * x[:, None, :]

    def set_at(arr, val):
        out = arr.clone()
        cur = arr[ar, idx]
        m = do.reshape((-1,) + (1,) * (cur.dim() - 1))
        out[ar, idx] = torch.where(m, val.to(arr.dtype), cur)
        return out

    return _payload_like(buf.replace(
        states=set_at(buf.states, state), probs=set_at(buf.probs, probs),
        score=set_at(buf.score, d),
        filled=set_at(buf.filled, torch.ones_like(do)),
        s_sum=buf.s_sum + add * state - sub * old_s,
        s_outer=(buf.s_outer + add[..., None] * outer(state)
                 - sub[..., None] * outer(old_s)),
        p_sum=buf.p_sum + add * probs - sub * old_p,
        n_filled=(buf.n_filled + do.to(buf.n_filled.dtype)
                  - evict.to(buf.n_filled.dtype)),
        actions=set_at(buf.actions, action.long()),
        logp=set_at(buf.logp, logp), rewards=set_at(buf.rewards, reward),
        values=set_at(buf.values, value), count=buf.count + 1), stored)


def buffer_insert_batch(cfg: FCPOConfig, buf: DiversityBuffer, states,
                        actions, logp, rewards, values, probs
                        ) -> DiversityBuffer:
    """Ingest a whole episode of T candidates per agent (every candidate
    array is (A, T, ...)). The sequential score -> argmin-evict -> scatter
    chain runs in K1 (CUDA) or its plain version (CPU); the non-scored
    payload is then scattered by last writer per slot. A narrower stored
    payload is read up to float32 around the launch and packed back."""
    stored, buf = buf, _payload_f32(buf)
    t_steps, n = states.shape[1], buf.score.shape[1]
    (new_states, new_probs, new_score, new_filled, s_sum, s_outer, p_sum,
     n_filled, slot, do, _d) = diversity_insert(
        buf.states, buf.probs, buf.score, buf.filled, buf.s_sum,
        buf.s_outer, buf.p_sum, buf.n_filled, states.contiguous(),
        probs.contiguous(), alpha=cfg.alpha, beta=cfg.beta, ridge=RIDGE)

    # last writer per slot: the highest t with do[t] & slot[t] == n wins
    ts = torch.arange(t_steps, device=slot.device)
    slots = torch.arange(n, device=slot.device)
    hits = (slot[:, None, :] == slots[None, :, None]) & do[:, None, :]
    last = torch.where(hits, ts, -1).amax(-1)                 # (A, N)
    take = last.clamp(0, t_steps - 1)
    keep = last < 0

    def scatter(old, cand):
        idx = take.reshape(take.shape + (1,) * (cand.dim() - 2))
        gathered = torch.gather(cand, 1, idx.expand(
            (-1, -1) + tuple(cand.shape[2:])))
        k = keep.reshape(keep.shape + (1,) * (old.dim() - 2))
        return torch.where(k, old, gathered)

    return _payload_like(buf.replace(
        states=new_states, probs=new_probs, score=new_score,
        filled=new_filled, s_sum=s_sum, s_outer=s_outer, p_sum=p_sum,
        n_filled=n_filled,
        actions=scatter(buf.actions, actions.long()),
        logp=scatter(buf.logp, logp), rewards=scatter(buf.rewards, rewards),
        values=scatter(buf.values, values), count=buf.count + t_steps),
        stored)


def buffer_resync(buf: DiversityBuffer) -> DiversityBuffer:
    """Recompute the streaming moments from the stored slots — bounds the
    float32 rank-1 add/subtract drift; runs on the FL-round cadence. The
    moments are built from the dequantized slots."""
    f32 = _payload_f32(buf)
    w = buf.filled.to(buf.s_sum.dtype)
    sw = f32.states * w[..., None]
    return buf.replace(
        s_sum=sw.sum(1),
        s_outer=torch.einsum("and,ane->ade", sw, f32.states),
        p_sum=(f32.probs * w[..., None]).sum(1),
        n_filled=buf.filled.sum(-1).to(buf.n_filled.dtype))


def buffer_diversity_mean(buf: DiversityBuffer) -> torch.Tensor:
    """(A,) mean stored diversity over capacity — the Eq. 7 "data
    diversity" client-selection stat."""
    return torch.where(buf.filled, buf.score, 0.0).mean(-1)


def buffer_clear(buf: DiversityBuffer) -> DiversityBuffer:
    """Empty the buffers and reset their streaming moments."""
    return buf.replace(filled=torch.zeros_like(buf.filled),
                       score=torch.full_like(buf.score, -torch.inf),
                       s_sum=torch.zeros_like(buf.s_sum),
                       s_outer=torch.zeros_like(buf.s_outer),
                       p_sum=torch.zeros_like(buf.p_sum),
                       n_filled=torch.zeros_like(buf.n_filled))


def buffer_memory_bytes(cfg: FCPOConfig) -> int:
    """Bytes of one agent's float32 buffer, from shapes and dtypes (built
    on the ``meta`` device: nothing is allocated). The port stores
    ``actions`` int64, 12·N bytes more than the reference's int32."""
    buf = buffer_init(cfg, 1, device="meta")
    return sum(x.numel() * x.element_size()
               for x in (getattr(buf, f.name) for f in fields(buf)))
