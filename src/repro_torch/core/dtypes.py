"""Fleet state dtype policies: narrow storage, float32 math.

Port of ``repro.core.dtypes``. A ``StatePolicy`` names the *storage* dtype
of each family of the fleet's state; every consumer reads a narrow leaf up
to float32, computes, and writes the result back at the stored dtype
(``tree_cast_like``). Families:

  * ``opt``       — Adam first/second moments (``opt["m"|"v"]``)
  * ``env``       — float leaves of the per-agent env state and env params
  * ``transport`` — codec residuals and parked async deltas
  * ``buffer``    — diversity-buffer payload; ``int8`` packs the stored
                    states/probs slots at the fixed scales below and keeps
                    logp/rewards/values bfloat16; the scores and the
                    streaming moments stay float32 under every policy
  * ``model``     — agent params and the per-pod base networks

``float32`` is the identity: ``Tensor.to`` of a tensor's own dtype returns
the tensor itself, so a float32 fleet runs the same kernels on the same
tensors as a fleet built without a policy.

The reference's bf16 arithmetic, as XLA compiles it on the CPU, keeps
intermediate results in float32 ("excess precision") and rounds only where
a value is stored; a Python literal meeting a bf16 array is rounded to bf16
first (JAX's weak typing). ``weak`` gives that literal; the consumers in
``core/env.py`` and ``core/backends.py`` upcast the rest explicitly.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass

import numpy as np
import torch

# Fixed int8 scales of the buffer slots: observation coordinates are
# non-negative and O(1) (1/32 covers [0, 3.97]); probabilities live in
# [0, 1] (1/127 is exact at the ends). Fixed scales keep the state's layout
# the same under every policy.
STATE_SCALE = 1.0 / 32.0
PROB_SCALE = 1.0 / 127.0

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


@dataclass(frozen=True)
class StatePolicy:
    """Storage dtypes of the fleet's state families."""
    name: str = "float32"
    opt: str = "float32"
    env: str = "float32"
    transport: str = "float32"
    buffer: str = "float32"      # "float32" | "bfloat16" | "int8"
    model: str = "float32"


POLICIES = {
    # the default: the same tensors as a fleet built without a policy
    "float32": StatePolicy(),
    # moments, env, transport and buffer in bf16; the model stays float32
    "bf16": StatePolicy(name="bf16", opt="bfloat16", env="bfloat16",
                        transport="bfloat16", buffer="bfloat16"),
    # bf16 everywhere and int8 buffer slots (>= 2x fewer bytes per agent)
    "lean": StatePolicy(name="lean", opt="bfloat16", env="bfloat16",
                        transport="bfloat16", buffer="int8",
                        model="bfloat16"),
}


def get_policy(policy) -> StatePolicy:
    """A policy name, a ``StatePolicy`` or None (float32)."""
    if policy is None:
        return POLICIES["float32"]
    if isinstance(policy, StatePolicy):
        return policy
    if policy not in POLICIES:
        raise ValueError(f"unknown state policy {policy!r}; expected one of "
                         f"{tuple(POLICIES)} or a StatePolicy")
    return POLICIES[policy]


def torch_dtype(name) -> torch.dtype:
    """A storage dtype name (``"float32"``, ``"bfloat16"``, ``"int8"``) or
    a ``torch.dtype`` as a ``torch.dtype``."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def tree_map(fn, *trees):
    """``fn`` over the tensors of dicts / dataclasses / tuples of one
    layout; anything else (None, ints, generators) passes through from the
    first tree."""
    t = trees[0]
    if torch.is_tensor(t):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if is_dataclass(t) and not isinstance(t, type):
        return type(t)(**{f.name: tree_map(fn, *(getattr(x, f.name)
                                                  for x in trees))
                          for f in fields(t)})
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return t


def cast_floats(tree, dtype):
    """Every floating tensor of ``tree`` to ``dtype``; integer and bool
    tensors pass through. The identity on leaves already at ``dtype``."""
    dt = torch_dtype(dtype)
    return tree_map(lambda x: x.to(dt) if x.is_floating_point() else x, tree)


def tree_cast_like(tree, like):
    """Each tensor of ``tree`` to the dtype of its counterpart in ``like``:
    the write-back half of compute-in-float32 / store-narrow."""
    return tree_map(lambda x, l: x.to(l.dtype), tree, like)


def tree_f32(tree):
    """Every floating tensor up to float32 (the identity on float32)."""
    return cast_floats(tree, torch.float32)


def quant8(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Fixed-scale symmetric int8 quantization, round half to even. The
    division by ``scale`` is a product with its float32 reciprocal, as the
    reference computes it compiled (1/scale is 32 and 127, both exact).
    ``quant8(dequant8(q)) == q``."""
    inv = float(1.0 / torch.tensor(scale, dtype=torch.float32))
    return torch.clamp(torch.round(x.float() * inv), -127, 127) \
        .to(torch.int8)


def dequant8(q: torch.Tensor, scale: float) -> torch.Tensor:
    return q.to(torch.float32) * scale


def weak(x: float, like: torch.Tensor) -> float:
    """The Python literal ``x`` as the reference computes it against an
    array of ``like``'s dtype: rounded to that dtype (JAX's weak typing).
    ``x`` itself for float32."""
    if like.dtype == torch.float32:
        return x
    return float(torch.tensor(x, dtype=like.dtype))


def tree_bytes(tree) -> int:
    """Storage bytes of the tensors of a tree."""
    total = 0

    def add(x):
        nonlocal total
        total += x.numel() * x.element_size()
    tree_map(add, tree)
    return total


def from_numpy(x, device="cpu") -> torch.Tensor:
    """A tensor from a numpy array of the numpy carry, keeping its dtype:
    2-byte raw or ``bfloat16`` arrays (``|V2``, ``uint16``) become bf16,
    float64 becomes float32, anything else keeps its dtype."""
    x = np.asarray(x)
    if x.dtype == np.uint16 or (x.dtype.kind == "V" and x.dtype.itemsize == 2):
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int16)
                                .copy()).view(torch.bfloat16).to(device)
    t = torch.tensor(x, device=device)
    return t.float() if t.dtype == torch.float64 else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The numpy form of ``t``; bf16 as raw 2-byte ``|V2`` values (what
    ``np.savez`` stores for a bfloat16 array)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()
