"""iAgent — the paper's per-model actor-critic network (Fig. 4), stacked.

Port of ``repro.core.agent``. Input (8) -> backbone 8 -> 64 -> 48 (ReLU),
one value head, three *cascaded* action heads: the resolution head reads the
backbone features, and its softmax output is concatenated onto the features
for the batch-size and multi-threading heads.

``AgentPolicy`` is an ``nn.Module`` holding n stacked agents (the fleet's A
agents, or the P pod base networks) in the JAX layout — ``w: (n, d_in,
d_out)``, ``b: (n, d_out)``, ``y = x @ w + b`` — so weights carry across
from the JAX package by copy. Its parameter names (``backbone.l1.w``, ...)
are the JAX tree paths joined by dots. The math (``agent_forward`` and
friends) is functional over a ``{name: tensor}`` mapping, so the optimizer,
Algorithm 1 and the codec work on plain dicts; the module is the container.

Heterogeneous action spaces are per-agent boolean masks; masked logits are
set to -1e30. The single-head ablation (Fig. 12, ``cfg.single_head``) has
one joint head ``head_res`` over n_res·n_bs·n_mt actions and no
``head_bs`` / ``head_mt``; its forward returns the three marginals (so the
buffer, the losses and Algorithm 1 see the same interface) plus
``"joint"``, and one Gumbel-max draw over the joint picks all three
actions (``noise_width``).
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Dict, Mapping

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.dtypes import from_numpy, to_numpy
from repro_torch.distributed.sharding import agent_slice

BACKBONE_KEYS = ("backbone", "value")          # equally-aggregated (Alg. 1)
HEAD_KEYS = ("head_res", "head_bs", "head_mt")  # loss-weighted layers


@dataclass
class ActionMask:
    """Per-agent valid-action masks (True = allowed), (A, n_*) bool."""
    res: torch.Tensor
    bs: torch.Tensor
    mt: torch.Tensor


def full_mask(cfg: FCPOConfig, n_agents: int, device="cuda") -> ActionMask:
    dev = resolve_device(device)
    ones = lambda n: torch.ones(n_agents, n, dtype=torch.bool, device=dev)
    return ActionMask(ones(cfg.n_res), ones(cfg.n_bs), ones(cfg.n_mt))


class StackedLinear(nn.Module):
    """n independent linear layers, ``x @ w + b`` per stacked row."""

    def __init__(self, n: int, d_in: int, d_out: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(n, d_in, d_out, device=device))
        self.b = nn.Parameter(torch.zeros(n, d_out, device=device))


class AgentPolicy(nn.Module):
    """n stacked iAgents; leading axis n on every parameter."""

    def __init__(self, cfg: FCPOConfig, n: int, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        hd = cfg.hidden_dim * cfg.hidden_scale
        fd = cfg.feat_dim * cfg.hidden_scale
        self.backbone = nn.ModuleDict({
            "l1": StackedLinear(n, cfg.state_dim, hd, dev),
            "l2": StackedLinear(n, hd, fd, dev)})
        self.value = StackedLinear(n, fd, 1, dev)
        if cfg.single_head:     # Fig. 12: one joint head, JAX's name for it
            self.head_res = StackedLinear(
                n, fd, cfg.n_res * cfg.n_bs * cfg.n_mt, dev)
            return
        self.head_res = StackedLinear(n, fd, cfg.n_res, dev)
        self.head_bs = StackedLinear(n, fd + cfg.n_res, cfg.n_bs, dev)
        self.head_mt = StackedLinear(n, fd + cfg.n_res, cfg.n_mt, dev)

    def params(self) -> Dict[str, torch.Tensor]:
        """The live parameters by dotted name (autograd leaves)."""
        return dict(self.named_parameters())

    @torch.no_grad()
    def assign(self, new: Mapping[str, torch.Tensor]) -> None:
        """Overwrite every parameter in place from ``new`` (same names)."""
        for name, p in self.named_parameters():
            p.copy_(new[name])


def agent_init(cfg: FCPOConfig, n: int, generator: torch.Generator,
               device="cuda") -> AgentPolicy:
    """n freshly initialised agents: every layer U(-1/sqrt(d_in),
    1/sqrt(d_in)) as the JAX package draws it (other random numbers)."""
    policy = AgentPolicy(cfg, n, device)
    with torch.no_grad():
        for layer in policy.modules():
            if isinstance(layer, StackedLinear):
                lim = 1.0 / math.sqrt(layer.w.shape[1])
                for p in (layer.w, layer.b):
                    u = torch.rand(p.shape, generator=generator,
                                   device=generator.device)
                    p.copy_(u * (2 * lim) - lim)
    return policy


def tensors_from_numpy(tree, device="cuda") -> Dict[str, torch.Tensor]:
    """``{dotted name: tensor}`` from a nested dict of numpy arrays in the
    JAX layout (``jax.tree.map(np.asarray, params)``). Each leaf keeps its
    dtype: float32, or bf16 from raw 2-byte (``|V2``) or ``uint16`` views
    (float64 becomes float32)."""
    dev = resolve_device(device)
    return {k: from_numpy(v, dev) for k, v in _flatten(tree).items()}


def params_from_numpy(cfg: FCPOConfig, tree, device="cuda") -> AgentPolicy:
    """An ``AgentPolicy`` holding the stacked weights of a nested dict of
    numpy arrays in the JAX layout, at the leaves' dtype."""
    flat = tensors_from_numpy(tree, device)
    first = next(iter(flat.values()))
    policy = AgentPolicy(cfg, first.shape[0], device).to(first.dtype)
    policy.assign(flat)
    return policy


def params_to_numpy(params: Mapping[str, torch.Tensor]):
    """The nested-dict numpy form of a ``{dotted name: tensor}`` mapping
    (the reverse of ``params_from_numpy``; bf16 leaves as ``|V2``)."""
    out: dict = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = to_numpy(t)
    return out


def policy_cast(policy: AgentPolicy, dtype) -> AgentPolicy:
    """``policy`` with its parameters stored at ``dtype``: the module itself
    when they already are, else a converted copy."""
    if all(p.dtype == dtype for p in policy.parameters()):
        return policy
    return copy.deepcopy(policy).to(dtype)


def _flatten(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, f"{prefix}{k}."))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def _linear(params, name, x):
    # bf16 parameters compute on float32 copies (the reference promotes
    # ``x_f32 @ w_bf16`` to float32); the identity on float32 parameters
    w, b = params[f"{name}.w"].float(), params[f"{name}.b"].float()
    n = w.shape[0]
    y = torch.matmul(x.reshape(n, -1, x.shape[-1]), w)
    y = y.reshape(*x.shape[:-1], w.shape[-1])
    return y + b.reshape(n, *([1] * (x.dim() - 2)), -1)


def _masked(mask, logits):
    m = mask.reshape(mask.shape[0], *([1] * (logits.dim() - 2)), -1)
    return torch.where(m, logits, -1e30)


def joint_mask(mask: ActionMask) -> torch.Tensor:
    """(A, n_res·n_bs·n_mt) bool: the joint action allowed iff each of its
    three parts is."""
    m = (mask.res[:, :, None, None] & mask.bs[:, None, :, None]
         & mask.mt[:, None, None, :])
    return m.reshape(m.shape[0], -1)


def agent_forward(cfg: FCPOConfig, params, state, mask: ActionMask):
    """state: (A, ..., 8) -> dict of masked log-probs per head + value
    (single head: the marginals of the joint, and ``"joint"``)."""
    h = torch.relu(_linear(params, "backbone.l1", state))
    feat = torch.relu(_linear(params, "backbone.l2", h))
    value = _linear(params, "value", feat)[..., 0]

    if cfg.single_head:
        logits = _masked(joint_mask(mask), _linear(params, "head_res", feat))
        logp = torch.log_softmax(logits, dim=-1)
        lp = logp.reshape(logp.shape[:-1] + (cfg.n_res, cfg.n_bs, cfg.n_mt))
        return {"res": torch.logsumexp(lp, dim=(-2, -1)),
                "bs": torch.logsumexp(lp, dim=(-3, -1)),
                "mt": torch.logsumexp(lp, dim=(-3, -2)),
                "joint": logp, "value": value}

    res_logits = _masked(mask.res, _linear(params, "head_res", feat))
    res_probs = torch.softmax(res_logits, dim=-1)
    # cascade: resolution distribution feeds the other two heads
    feat_c = torch.cat([feat, res_probs], dim=-1)
    bs_logits = _masked(mask.bs, _linear(params, "head_bs", feat_c))
    mt_logits = _masked(mask.mt, _linear(params, "head_mt", feat_c))
    return {
        "res": torch.log_softmax(res_logits, dim=-1),
        "bs": torch.log_softmax(bs_logits, dim=-1),
        "mt": torch.log_softmax(mt_logits, dim=-1),
        "value": value,
    }


def noise_width(cfg: FCPOConfig) -> int:
    """Gumbel values one action draw takes: n_res+n_bs+n_mt (one per
    option of each head), or n_res·n_bs·n_mt for the single joint head."""
    if cfg.single_head:
        return cfg.n_res * cfg.n_bs * cfg.n_mt
    return cfg.n_res + cfg.n_bs + cfg.n_mt


def sample_gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise, ``-log(-log(U))`` with U in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _take(logp, a):
    return torch.gather(logp, -1, a.unsqueeze(-1)).squeeze(-1)


def sample_actions(cfg: FCPOConfig, params, state, mask: ActionMask,
                   gumbel=None, generator=None, place=None):
    """Sample (res, bs, mt) per agent by Gumbel-max: ``argmax(logp + g)``.

    ``gumbel`` ((A, ``noise_width(cfg)``)) is pre-drawn noise; without it
    the noise is drawn from ``generator``: for the whole fleet under a
    meshed fleet's placement ``place``, which keeps this rank's rows (so
    agent i's draw does not depend on the world size). The single head
    draws one joint action and decodes it. Returns (actions (A, 3) long,
    logp (A,), out-dict)."""
    out = agent_forward(cfg, params, state, mask)
    if gumbel is None:
        rows = state.shape[:-1] if place is None else (place.n_agents,)
        gumbel = agent_slice(sample_gumbel(rows + (noise_width(cfg),),
                                           generator), place)
    if cfg.single_head:
        aj = torch.argmax(gumbel + out["joint"], dim=-1)
        nbm = cfg.n_bs * cfg.n_mt
        actions = torch.stack([torch.div(aj, nbm, rounding_mode="floor"),
                               torch.div(aj, cfg.n_mt, rounding_mode="floor")
                               % cfg.n_bs, aj % cfg.n_mt], dim=-1)
        return actions, _take(out["joint"], aj), out
    g_res, g_bs, g_mt = torch.split(gumbel, [cfg.n_res, cfg.n_bs, cfg.n_mt],
                                    dim=-1)
    a = [torch.argmax(g + out[h], dim=-1)
         for g, h in ((g_res, "res"), (g_bs, "bs"), (g_mt, "mt"))]
    logp = (_take(out["res"], a[0]) + _take(out["bs"], a[1])
            + _take(out["mt"], a[2]))
    return torch.stack(a, dim=-1), logp, out


def action_logp(cfg: FCPOConfig, params, state, actions, mask: ActionMask):
    """Log-prob of given actions (A, ..., 3) under ``params``; also the
    value and the concatenated policy distribution."""
    out = agent_forward(cfg, params, state, mask)
    actions = actions.long()
    if cfg.single_head:
        logp = _take(out["joint"], actions[..., 0] * (cfg.n_bs * cfg.n_mt)
                     + actions[..., 1] * cfg.n_mt + actions[..., 2])
    else:
        logp = (_take(out["res"], actions[..., 0])
                + _take(out["bs"], actions[..., 1])
                + _take(out["mt"], actions[..., 2]))
    probs = torch.cat([out["res"].exp(), out["bs"].exp(), out["mt"].exp()],
                      dim=-1)
    return logp, out["value"], probs
