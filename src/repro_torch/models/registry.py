"""Architecture registry of the port: id -> (config, init, apply, cache).

Port of ``repro.models.registry``: the transformer family (dense, moe,
encoder, vlm), the hybrid (zamba2, ``models/hybrid.py``) and the SSM
family (xlstm), plus the weight carry between the two packages:
``params_from_numpy`` reads the JAX package's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and ``params_to_numpy``
writes the port's back. The two trees have the same nesting (dicts, and
the lists ``first_blocks`` and xlstm's ``blocks``), keys, shapes and
layout (dense weights (d_in, d_out), block parameters, zamba2's Mamba
layers included, stacked on a leading L axis): no transposition.

``input_specs(cfg, shape)`` gives the (shape, dtype) of every model input
of one (arch, shape) cell, allocating nothing.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import hybrid, transformer


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable[..., Any]        # (generator) -> params on its device
    apply: Callable[..., Any]       # (params, batch, cache=None, ...) -> (logits, cache, aux)
    new_cache: Callable[..., Any]   # (batch, max_len, dtype, device) -> cache


def get_model(cfg: ArchConfig) -> Model:
    transformer.check_ported(cfg)
    if cfg.family in ("hybrid", "ssm"):
        init, apply, spec = (
            (hybrid.zamba2_init, hybrid.zamba2_apply,
             hybrid.zamba2_cache_spec) if cfg.family == "hybrid" else
            (hybrid.xlstm_init, hybrid.xlstm_apply, hybrid.xlstm_cache_spec))
        return Model(
            cfg,
            lambda gen: init(cfg, gen),
            lambda p, b, cache=None, **kw: apply(cfg, p, b, cache, **kw),
            lambda batch, max_len, dtype=torch.bfloat16, device="cuda":
                transformer.new_cache(cfg, batch, max_len, dtype, device,
                                      spec))
    return Model(
        cfg,
        lambda gen: transformer.transformer_init(cfg, gen),
        lambda p, b, cache=None, **kw: transformer.transformer_apply(
            cfg, p, b, cache, **kw),
        lambda batch, max_len, dtype=torch.bfloat16, device="cuda":
            transformer.new_cache(cfg, batch, max_len, dtype, device))


def input_specs(cfg: ArchConfig,
                shape: InputShape) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """(shape, dtype) stand-ins for the model inputs of one grid cell."""
    b, s = shape.global_batch, shape.seq_len
    act = transformer.torch_dtype(cfg.dtype)
    if shape.kind == "decode":
        if cfg.frontend == "frames":
            return {"embeds": ((b, 1, cfg.frontend_dim), act)}
        return {"tokens": ((b, 1), torch.int32)}
    if cfg.frontend == "frames":  # hubert: precomputed frame embeddings
        batch = {"embeds": ((b, s, cfg.frontend_dim), act)}
        if shape.kind == "train":
            batch["mask"] = ((b, s), torch.bool)
            batch["labels"] = ((b, s), torch.int32)
        return batch
    batch = {"tokens": ((b, s), torch.int32)}
    if cfg.frontend == "patches":  # pixtral: precomputed patch embeddings
        batch["patches"] = ((b, cfg.n_patches, cfg.frontend_dim), act)
    if shape.kind == "train":
        batch["labels"] = ((b, s), torch.int32)
    return batch


def params_from_numpy(cfg: ArchConfig, tree, device="cuda"):
    """The JAX package's parameter tree (numpy leaves) as the port's, on
    ``device``, in ``cfg.param_dtype``. Every leaf keeps its shape."""
    dev = resolve_device(device)
    dtype = transformer.torch_dtype(cfg.param_dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, np.float32)).to(dev, dtype)

    return conv(tree)


def param_count(params) -> int:
    """The number of parameters in a tree of tensors (dicts and lists)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_count(v) for v in params)
    return params.numel()


def params_to_numpy(params):
    """The port's parameter tree as numpy float32 arrays (the JAX package's
    layout)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().float().cpu().numpy()
