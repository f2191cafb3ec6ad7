"""Divisibility-aware placement rules (DP/FSDP/TP/EP/SP) and the fleet's
collectives.

Port of ``repro.distributed.sharding``. Every logical tensor dim carries an
ordered list of candidate mesh axes (single names or tuples for composite
axes); ``greedy_spec`` assigns the first candidate whose axis product
divides the dim and whose axes are still unused for this tensor, else
leaves the dim replicated, so 28 heads or 40 experts fall through to the
next candidate instead of producing an invalid placement. A spec is a
tuple with one entry per leading dim, each None, an axis name or a tuple
of names; ``greedy_spec`` drops trailing Nones, as the JAX package's
``PartitionSpec`` construction does. The rules read only a mesh's
``{axis name: size}`` (``axis_sizes``): a ``DeviceMesh``, or any object
whose ``shape`` is such a mapping.

The parameter, batch and cache rules serve the LM side; the fleet rules
(``agent_spec``, ``pod_spec``, ``agent_batch_spec``) place the FCPO fleet:
agents over ``(pod, data)`` (or ``data``), per-pod base networks over the
FL hierarchy.

Where the JAX package hints a placement inside ``jit`` (``agent_hint``,
``pod_hint``) and lets XLA insert the collectives, the port calls them
itself: ``agent_allreduce`` sums per-agent partial sums over the ranks that
hold each agent once, ``agent_allgather`` / ``pod_allgather`` assemble an
agent- or pod-leading tensor from every rank's slice, ``agent_slice`` /
``pod_slice`` keep this rank's rows of a whole one. Each takes the fleet's
placement (``core.fleet.Placement``) and is the identity without one, or
where its axis is replicated over the ranks (every rank then already holds
every row, and a sum over ranks would count each agent once per rank).
``COLLECTIVES.launches`` counts the collectives issued, in the kernel
wrappers' form, so that the graph driver tops it up per replay;
``warm_groups`` issues one collective on each of a placement's groups
before the graph driver's first capture.
"""
from __future__ import annotations

import math
import re
from typing import Mapping, Optional, Tuple

import torch
import torch.distributed as dist

Spec = Tuple          # entries: None, an axis name, or a tuple of names


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a shape-only stand-in
    (an object whose ``shape`` is that mapping)."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def _axes_of(cand):
    return cand if isinstance(cand, tuple) else (cand,)


def greedy_spec(shape, dim_prefs, mesh, priority=None) -> Spec:
    """Assign the first still-unused, divisible candidate axis per dim.
    ``priority`` reorders which dims claim axes first (default: dim
    order)."""
    sizes = axis_sizes(mesh)
    used = set()
    spec = [None] * len(shape)
    order = priority if priority is not None else range(len(shape))
    for i in order:
        size, prefs = shape[i], (dim_prefs[i] if i < len(dim_prefs) else ())
        for cand in prefs or ():
            if cand is None:
                break
            axes = _axes_of(cand)
            if any(a in used or a not in sizes for a in axes):
                continue
            prod = math.prod(sizes[a] for a in axes)
            if prod > 1 and size % prod == 0:
                spec[i] = cand
                used.update(axes)
                break
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------
FSDP = ("data",)          # candidates for the "shard-for-memory" dim
TP = ("model",)           # candidates for the "shard-for-compute" dim
EP = ("model",)           # expert-parallel axis

# (path regex, dim_prefs for the *unstacked* shape)
_PARAM_RULES = [
    # embeddings / unembeddings: (vocab, d)
    (r"embed/table$", [TP, FSDP]),
    (r"lm_head/w$", [FSDP, TP]),
    (r"(frame|patch)_proj/w$", [None, TP]),
    # attention projections: (d, features) / (features, d)
    (r"attn/w[qkv]/w$", [FSDP, TP]),
    (r"attn/w[qkv]/b$", [TP]),
    (r"attn/wo/w$", [TP, FSDP]),
    # MLA
    (r"attn/wkv_a/w$", [FSDP, TP]),
    (r"attn/wkv_b/w$", [FSDP, TP]),
    # MLPs: (d, ff) up / (ff, d) down
    (r"mlp/(gate|up)/w$", [FSDP, TP]),
    (r"mlp/down/w$", [TP, FSDP]),
    # MoE: router (d, E); experts (E, d, f) / (E, f, d)
    (r"moe/router/w$", [FSDP, None]),
    (r"moe/(gate|up)$", [EP, FSDP, TP]),
    (r"moe/down$", [EP, TP, FSDP]),
    (r"moe/shared/(gate|up)/w$", [FSDP, TP]),
    (r"moe/shared/down/w$", [TP, FSDP]),
    # mamba2
    (r"mamba/in_proj/w$", [FSDP, TP]),
    (r"mamba/out_proj/w$", [TP, FSDP]),
    (r"mamba/conv_w$", [None, TP]),
    (r"mamba/conv_b$", [TP]),
    # xlstm cells
    (r"cell/w[qkvif]/w$", [FSDP, TP]),
    (r"cell/(wo_gate|out_proj)/w$", [TP, FSDP]),
    (r"cell/w_in/w$", [FSDP, TP]),
    # generic biases / norms / small vectors: replicate
    (r"(ln\d?|norm|final_norm|kv_norm)/", []),
]

_STACKED_PREFIXES = ("blocks/", "mamba/")  # leading layer dim present


def strip_axis(spec: Spec, axis: str) -> Spec:
    """Remove one mesh axis from a spec (e.g. drop FSDP for serving)."""
    out = []
    for entry in spec:
        if entry == axis:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a != axis)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
        else:
            out.append(entry)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def param_spec(path: str, shape, mesh, fsdp: bool = True) -> Spec:
    """The spec of the parameter at ``path`` (``blocks/attn/wq/w``: the
    pytree path joined by ``/``). ``fsdp=False`` drops the ``data``-axis
    (ZeRO) sharding — the serving profile: weights live TP-sharded and are
    never re-gathered per step."""
    lead = 1 if path.startswith(_STACKED_PREFIXES) else 0
    core_shape = shape[lead:]
    spec = None
    for pat, prefs in _PARAM_RULES:
        if re.search(pat, path):
            spec = greedy_spec(core_shape, prefs, mesh)
            break
    if spec is None:
        # generic fallback: biggest dim -> model, next -> data (if divisible)
        if len(core_shape) >= 2 and math.prod(core_shape) >= 1 << 16:
            order = sorted(range(len(core_shape)), key=lambda i: -core_shape[i])
            prefs = [[] for _ in core_shape]
            prefs[order[0]] = TP
            if len(order) > 1:
                prefs[order[1]] = FSDP
            spec = greedy_spec(core_shape, prefs, mesh)
        else:
            spec = ()
    if not fsdp:
        spec = strip_axis(spec, "data")
    return tuple([None] * lead + list(spec))


# ---------------------------------------------------------------------------
# Input / activation / cache rules
# ---------------------------------------------------------------------------
BATCH = (("pod", "data"), "data", "pod")   # composite first, then singles


def batch_spec(shape, mesh, seq_axis: Optional[int] = None) -> Spec:
    """Shard dim0 over batch candidates; optionally dim ``seq_axis`` over
    the model axis (sequence parallelism) when batch can't fill the
    mesh."""
    prefs = [list(BATCH)] + [[] for _ in shape[1:]]
    if seq_axis is not None:
        prefs[seq_axis] = ["model"]
    return greedy_spec(shape, prefs, mesh)


def cache_spec(path: str, shape, mesh, stacked: bool = True) -> Spec:
    """KV/state cache rule for the leaf at ``path``. Leaf layouts (possibly
    with a leading layer dim): GQA (B, S, H, D) — batch over (pod, data);
    heads over model, else seq. MLA (B, S, r) — batch; r over model, else
    seq. SSM (B, H, P, N) / (B, H, P) / conv (B, K, C) — batch; heads/C
    over model."""
    if path.endswith("offset") or len(shape) == 0:
        return ()
    lead = 0
    core = list(shape)
    # a stacked tree puts the layer dim first
    if stacked and ("layers/" in path or path.startswith("mamba")
                    or path.startswith("attn")):
        lead = 1
        core = list(shape[1:])
    prefs = [[] for _ in core]
    prefs[0] = list(BATCH)
    priority = None
    if len(core) == 4:      # (B, S, H, D) or (B, H, P, N)
        if "mamba" in path or path.endswith(("C", "h")):
            prefs[1] = ["model"]            # heads
        else:
            prefs[2] = ["model"]            # kv heads first ...
            prefs[1] = ["model"]            # ... else sequence
            priority = [0, 2, 1, 3]
    elif len(core) == 3:    # (B, S, r) or (B, K, C) or (B, H, P)
        prefs[2] = ["model"]
        prefs[1] = ["model"]
        priority = [0, 2, 1]
    elif len(core) == 2:
        prefs[1] = ["model"]
    spec = greedy_spec(core, prefs, mesh, priority)
    return tuple([None] * lead + list(spec))


def cache_specs(shapes: Mapping[str, tuple], mesh, stacked: bool = True):
    """``{path: spec}`` of a cache tree given as ``{path: shape}``."""
    return {p: cache_spec(p, s, mesh, stacked) for p, s in shapes.items()}


def logits_spec(mesh) -> Spec:
    """(B, 1, vocab) logits: batch over the batch candidates, vocab over
    the model axis."""
    return greedy_spec((1 << 30, 1, 1 << 30), [list(BATCH), [], ["model"]],
                       mesh)


# ---------------------------------------------------------------------------
# Fleet (FCPO agent-axis) rules
# ---------------------------------------------------------------------------
# Agent-stacked leaves (A, ...): the agent axis is the fleet's data
# parallelism — spread over (pod, data) when A fills both, else data alone.
AGENT = (("pod", "data"), "data")
# Per-pod base networks (P, ...): the FL hierarchy. Pods ride the mesh's
# ``pod`` axis when present; on a 2D mesh the ``data`` candidate only
# engages when P divides the data axis size — otherwise the (small) base
# networks replicate, which is always valid.
POD = ("pod", "data")


def agent_spec(shape, mesh) -> Spec:
    """Shard an agent-stacked leaf's leading dim over the agent candidates;
    trailing (per-agent) dims are tiny and stay replicated."""
    if not shape:
        return ()
    return greedy_spec(shape, [list(AGENT)], mesh)


def pod_spec(shape, mesh) -> Spec:
    """Shard a per-pod leaf's leading dim over the FL-hierarchy
    candidates."""
    if not shape:
        return ()
    return greedy_spec(shape, [list(POD)], mesh)


def agent_batch_spec(shape, mesh, agent_axis: int = 1) -> Spec:
    """Episode-major driver inputs, e.g. rates (n_eps, A, n_steps): shard
    the *agent* dim over the agent candidates, replicate the scan/time
    dims."""
    prefs = [[] for _ in shape]
    if agent_axis < len(shape):
        prefs[agent_axis] = list(AGENT)
    return greedy_spec(shape, prefs, mesh)


def spec_axes(spec: Spec, dim: int = 0) -> Tuple[str, ...]:
    """The mesh axes that dim ``dim`` of ``spec`` is split over (empty:
    replicated)."""
    if dim >= len(spec) or spec[dim] is None:
        return ()
    return _axes_of(spec[dim])


# ---------------------------------------------------------------------------
# Collectives of the fleet's placement
# ---------------------------------------------------------------------------
class _Count:
    """A launch counter in the kernel wrappers' form (``launches``)."""

    def __init__(self):
        self.launches = 0


COLLECTIVES = _Count()


def agent_allreduce(x: torch.Tensor, place) -> torch.Tensor:
    """The sum over every agent of per-agent partial sums ``x`` (this
    rank's agents' sum), in place: an all-reduce over the ranks that hold
    each agent once; ``x`` itself where agents are not split (no
    placement, or replicated agents)."""
    if place is None or place.agent_group is None:
        return x
    COLLECTIVES.launches += 1
    dist.all_reduce(x, group=place.agent_group)
    return x


def warm_groups(place, device) -> list:
    """One eager all-reduce on each distinct process group of ``place``
    (the world, the agent and the pod group), so that no group's
    communicator is first created inside a CUDA graph's capture (NCCL
    creates it at the group's first collective). Not counted in
    ``COLLECTIVES``. Returns the sizes of the groups warmed, in order."""
    seen, sizes = [], []
    for group in (place.world, place.agent_group, place.pod_group):
        if group is None or any(group is g for g in seen):
            continue
        seen.append(group)
        dist.all_reduce(torch.zeros(1, device=device), group=group)
        sizes.append(dist.get_world_size(group))
    return sizes


def _allgather(x: torch.Tensor, group) -> torch.Tensor:
    COLLECTIVES.launches += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def agent_allgather(x: torch.Tensor, place) -> torch.Tensor:
    """The whole fleet's (A, ...) tensor from every rank's (A_local, ...)
    slice, in agent order; ``x`` itself where agents are not split."""
    if place is None or place.agent_group is None:
        return x
    return _allgather(x, place.agent_group)


def pod_allgather(x: torch.Tensor, place) -> torch.Tensor:
    """The whole (P, ...) per-pod tensor from every rank's (P_local, ...)
    slice; ``x`` itself where pods are not split."""
    if place is None or place.pod_group is None:
        return x
    return _allgather(x, place.pod_group)


def agent_slice(x, place, dim: int = 0):
    """This rank's agents of a whole fleet's tensor or array (agent axis
    ``dim``); ``x`` itself without a placement."""
    if place is None:
        return x
    return x[(slice(None),) * dim + (place.agents,)]


def pod_slice(x, place, dim: int = 0):
    """This rank's pods of a whole (P, ...) tensor or array."""
    if place is None:
        return x
    return x[(slice(None),) * dim + (place.pods,)]
