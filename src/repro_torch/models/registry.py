"""Architecture registry of the port: id -> (config, init, apply, cache).

Port of ``repro.models.registry`` for the dense family, plus the weight
carry between the two packages: ``params_from_numpy`` reads the JAX
package's parameter tree as numpy arrays (``jax.tree.map(np.asarray,
params)``) and ``params_to_numpy`` writes the port's back. The two trees
have the same nesting, keys, shapes and layout (dense weights (d_in,
d_out), block parameters stacked on a leading L axis): no transposition.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable[..., Any]        # (generator) -> params on its device
    apply: Callable[..., Any]       # (params, batch, cache=None, ...) -> (logits, cache, aux)
    new_cache: Callable[..., Any]   # (batch, max_len, dtype, device) -> cache


def get_model(cfg: ArchConfig) -> Model:
    transformer.check_ported(cfg)
    return Model(
        cfg,
        lambda gen: transformer.transformer_init(cfg, gen),
        lambda p, b, cache=None, **kw: transformer.transformer_apply(
            cfg, p, b, cache, **kw),
        lambda batch, max_len, dtype=torch.bfloat16, device="cuda":
            transformer.new_cache(cfg, batch, max_len, dtype, device))


def params_from_numpy(cfg: ArchConfig, tree, device="cuda"):
    """The JAX package's parameter tree (numpy leaves) as the port's, on
    ``device``, in ``cfg.param_dtype``. Every leaf keeps its shape."""
    dev = resolve_device(device)
    dtype = transformer.torch_dtype(cfg.param_dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, np.float32)).to(dev, dtype)

    return conv(tree)


def params_to_numpy(params):
    """The port's parameter tree as numpy float32 arrays (the JAX package's
    layout)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()
