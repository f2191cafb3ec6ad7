"""Training step: loss, remat, microbatch gradient accumulation.

Port of ``repro.training.train_step``. ``make_train_step`` builds a
function ``(state, batch) -> (state, metrics)`` over trees of tensors.
Gradients come from autograd over the model's plain path
(``use_kernels=False``): the reference's train step reaches no Pallas
kernel either, and K4 has no backward kernel in either package.
``remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint`` does.
Microbatching splits the batch on its leading axis and accumulates the
gradients in float32; as in the reference, the microbatched metrics
report ``moe_aux`` as 0 and ``ce`` as the mean total loss.

A non-finite loss or a NaN / Inf anywhere in the updated parameters
rejects the whole step: parameters and optimizer state keep their old
values (a ``torch.where``, no host synchronization) and
``update_rejected`` counts it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.dtypes import tree_map
from repro_torch.models.registry import Model
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, flatten)


def cross_entropy(logits, labels, mask=None, impl="gather"):
    logits = logits.float()
    if impl == "sharded":
        # the reference's vocab-shard-friendly form: the gold logit from a
        # compare + select + reduce instead of a gather over the vocab
        m = logits.amax(-1, keepdim=True).detach()
        logz = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
        idx = torch.arange(logits.shape[-1], dtype=labels.dtype,
                           device=logits.device)
        hit = labels[..., None] == idx
        gold = torch.where(hit, logits, 0.0).sum(-1)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp_min(m.sum(), 1.0)
    return nll.mean()


def make_loss_fn(model: Model, moe_aux_weight: float = 0.01,
                 remat: bool = True):
    """(params, batch) -> (total loss, {"ce", "moe_aux"})."""
    cfg = model.cfg

    def loss_fn(params, batch):
        logits, _, aux = model.apply(params, batch, remat=remat,
                                     use_kernels=False)
        if cfg.causal and "labels" in batch:   # next-token prediction
            loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                                 impl=cfg.ce_impl)
        elif "mask" in batch:                  # masked-unit (hubert)
            loss = cross_entropy(logits, batch["labels"], batch["mask"],
                                 impl=cfg.ce_impl)
        else:
            loss = cross_entropy(logits, batch["labels"], impl=cfg.ce_impl)
        total = loss + moe_aux_weight * aux["moe_aux"]
        return total, {"ce": loss, "moe_aux": aux["moe_aux"]}

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """((loss, extras), grads): ``loss_fn``'s value and its gradient with
    respect to every tensor of ``params`` (a tree of the same layout; the
    extras detached)."""
    leaves, rebuild = flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, extras = loss_fn(rebuild(leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return ((loss.detach(), tree_map(lambda x: x.detach(), extras)),
            rebuild(list(grads)))


def init_train_state(model: Model, gen: torch.Generator):
    params = model.init(gen)
    return {"params": params, "opt": adamw_init(params)}


def make_train_step(model: Model, opt_cfg: AdamWConfig = AdamWConfig(),
                    microbatches: int = 1, remat: bool = True,
                    moe_aux_weight: float = 0.01):
    loss_fn = make_loss_fn(model, moe_aux_weight, remat)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        if microbatches == 1:
            (loss, extras), grads = value_and_grad(loss_fn, params, batch)
        else:
            def split(x, i):
                b = x.shape[0]
                assert b % microbatches == 0
                n = b // microbatches
                return x[i * n:(i + 1) * n]

            g_sum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            l_sum = 0.0
            for i in range(microbatches):
                mb = {k: split(v, i) for k, v in batch.items()}
                (l, _), g = value_and_grad(loss_fn, params, mb)
                g_sum = tree_map(torch.add, g_sum, g)
                l_sum = l_sum + l
            grads = tree_map(lambda g: g / microbatches, g_sum)
            loss = l_sum / microbatches
            extras = {"ce": loss, "moe_aux": torch.zeros(
                (), dtype=torch.float32, device=loss.device)}

        new_params, new_opt, om = adamw_update(opt_cfg, params, grads,
                                               state["opt"])
        ok = torch.isfinite(loss)
        for leaf in flatten(new_params)[0]:
            ok = ok & torch.isfinite(leaf).all()
        # in place into the fresh tensors: no third copy of the state
        keep = lambda new, old: torch.where(ok, new, old, out=new)
        new_params = tree_map(keep, new_params, params)
        new_opt = tree_map(keep, new_opt, state["opt"])
        metrics = {"loss": loss, **extras, **om,
                   "update_rejected": (~ok).float()}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step
