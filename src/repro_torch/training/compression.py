"""Error-feedback int8 gradient compression for the data-parallel
all-reduce.

Port of ``repro.training.compression``. Each gradient leaf plus its
carried residual is quantized to int8 with one per-tensor scale, the
quantization error is kept as the next step's residual (error feedback),
and the dequantized values are summed over the data-parallel world and
divided by its size: over ``torch.distributed`` when a process group is
up, a world of one otherwise (the reference's ``psum`` over a one-device
``dp`` axis).

The quantizer is this module's plain per-tensor ``quantize_int8``, the
reference's ``kernels/ref.py::quantize_int8`` (scale ``max|x| * (1/127)``,
a division by it, round half to even, clip to +-127): as in the JAX
package, gradient compression does not reach the K2 ``delta_codec``
kernel, whose int8 scale is per agent row.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.dtypes import tree_map


def int8_scale(xf: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 scale: max|x| / 127, floored away from 0,
    written as a product with the reciprocal constant, as the reference
    writes it."""
    return torch.clamp_min(xf.abs().amax(), 1e-12) * (1.0 / 127.0)


def quantize_int8(x: torch.Tensor):
    """(q int8, scale float32 scalar)."""
    xf = x.float()
    scale = int8_scale(xf)
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), \
        scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def world_size(group=None) -> int:
    """The size of ``group`` (the default group) when a process group is
    up, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def compress_psum(grads, residuals, group=None):
    """int8 + error-feedback all-reduce of ``grads`` over ``group`` (the
    default group when one is up). Returns (mean grads, new residuals)."""
    world = world_size(group)

    def one(g, r):
        gf = g.float() + r
        q, scale = quantize_int8(gf)
        new_r = gf - dequantize_int8(q, scale)   # fed back next step
        summed = q.float() * scale
        if world > 1:
            dist.all_reduce(summed, group=group)
        return summed / float(world), new_r

    pairs = tree_map(one, grads, residuals)
    return _pick(pairs, 0), _pick(pairs, 1)


def _pick(tree, i):
    """The ``i``-th element of every (mean, residual) pair of a tree."""
    if isinstance(tree, tuple):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return [_pick(v, i) for v in tree]
