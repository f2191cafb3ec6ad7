"""AdamW with global-norm clipping and a cosine-with-warmup schedule.

Port of ``repro.training.optimizer``. Parameters, gradients and the
moments are trees of tensors (dicts and lists) of one layout; the update
is functional (new tensors), as the reference's, so that a train step can
keep the old state when it rejects an update. Trees are walked in the JAX
package's leaf order (dict keys sorted), so that sums over leaves (the
global norm) add in the reference's order.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Tuple

import torch

from repro_torch.core.dtypes import tree_map


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def flatten(tree) -> Tuple[List[torch.Tensor], Callable]:
    """The tensors of a tree of dicts and lists in JAX's leaf order, and
    the function that builds the tree back from such a list."""
    if torch.is_tensor(tree):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = sorted(tree)
    elif isinstance(tree, (list, tuple)):
        keys = range(len(tree))
    else:
        raise TypeError(f"not a tree of tensors: {type(tree).__name__}")
    parts = [flatten(tree[k]) for k in keys]
    sizes = [len(leaves) for leaves, _ in parts]

    def rebuild(xs):
        out, i = {}, 0
        for k, (_, fn), n in zip(keys, parts, sizes):
            out[k] = fn(xs[i:i + n])
            i += n
        if isinstance(tree, dict):
            return {k: out[k] for k in tree}
        return type(tree)(out[k] for k in keys)
    return [x for leaves, _ in parts for x in leaves], rebuild


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=flatten(params)[0][0].device)}


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm,
                                0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = flatten(tree)[0]
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / (norm + 1e-9), 1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def adamw_update(cfg: AdamWConfig, params, grads, state):
    """Returns (new_params, new_state, {"grad_norm", "lr"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    leaves, rebuild = flatten(params)
    out = [upd(*pgmv) for pgmv in zip(leaves, flatten(grads)[0],
                                       flatten(state["m"])[0],
                                       flatten(state["v"])[0])]
    new_p, new_m, new_v = (rebuild(list(x)) for x in zip(*out))
    return (new_p, {"m": new_m, "v": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})
