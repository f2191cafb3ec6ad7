"""Checkpoints of a fleet, in the JAX package's format.

Port of ``repro.training.checkpoint``. One ``.npz`` per step holds the
arrays keyed by the JAX ``Fleet``'s pytree paths (``0/.params/head_bs/w``,
``0/.buffer/.states``, ``1/head_bs/w``, ``8``, ``10/.has``, ...), beside a
JSON manifest with ``step``, ``arrays``, ``keys``, ``dtypes`` and
``extra``. bf16 leaves are stored as raw 2-byte ``|V2`` values with
``"bfloat16"`` in ``dtypes`` (what ``np.savez`` writes for a bfloat16
array), index leaves as int32 and the carried threefry keys as ``0/.rng``,
so either package restores the other's checkpoints. A fleet with health
state saves it under the JAX ``Fleet``'s 14th field (``13/.reward_hist``,
``13/.reward_p2/.q``, ``13/.drift_rate/.flag``, ...); a checkpoint without
it restores into a health fleet with the health state left out, for the
drivers to attach fresh state. The port adds its
generators' states under keys of its own (``torch/generator``,
``torch/fault_generator``), which the JAX package's ``restore`` ignores.

A meshed fleet (one that carries a ``core.fleet.Placement``) is saved
whole, in the same format: every rank calls ``save``, the ranks' slices
are gathered and rank 0 writes. ``restore`` into a meshed fleet reads the
whole file on every rank and keeps the rank's slice. So a meshed run
resumes meshless and the reverse, as the JAX checkpoints of sharded arrays
allow.

Any other state (an LM train state: ``{"params", "opt": {"m", "v",
"step"}, "ef"}``, a tree of dicts and lists of tensors) is saved through
``tree_flat``, keyed as the JAX package keys a pytree
(``params/embed/table``, ``params/blocks/0/cell/wq/w``, ``opt/step``), and
restored by ``restore_tree`` into the layout of a like tree: either
package restores the other's train checkpoints.

The hardening is the reference's: saves go to a temporary file renamed
into place (a crash mid-save never leaves a torn checkpoint), torn and
garbage manifests are skipped by ``latest_step``, a corrupt arrays file is
named in the error, and a missing manifest names the latest complete step.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import dtypes as dtp
from repro_torch.core.fleet import (Fleet, fleet_from_numpy, fleet_gather,
                                    fleet_shard, fleet_to_numpy)

BF16 = np.dtype("V2")        # the numpy carry's raw bf16
GENERATORS = {"torch/generator": "generator",
              "torch/fault_generator": "fault_generator"}

# (path in ``fleet_to_numpy``'s tree, JAX key, how the subtree is keyed:
# "attr" for a NamedTuple's fields (".name"), "dict" for a dict, None for a
# leaf). The order is the JAX Fleet's fields.
_LAYOUT = (
    (("params",), "0/.params", "dict"),
    (("opt", "m"), "0/.opt/m", "dict"),
    (("opt", "t"), "0/.opt/t", None),
    (("opt", "v"), "0/.opt/v", "dict"),
    (("buffer",), "0/.buffer", "attr"),
    (("env_state",), "0/.env_state", "attr"),
    (("rng",), "0/.rng", None),
    (("base_params",), "1", "dict"),
    (("env_params",), "2", "attr"),
    (("masks",), "3", "attr"),
    (("group_ids",), "4", "dict"),
    (("pod_ids",), "5", None),
    (("bandwidth",), "6", None),
    (("speeds",), "7", None),
    (("episode",), "8", None),
    (("residuals",), "9", "dict"),
    (("pending", "delta"), "10/.delta", "dict"),
    (("pending", "staleness"), "10/.staleness", None),
    (("pending", "has"), "10/.has", None),
    (("crash_timer",), "11", None),
    (("partition_timer",), "12", None),
    (("health",), "13", "attr"),        # only a fleet with health state
)
HEALTH_KEY = "13/"


def _jax_dtype(x: np.ndarray) -> np.ndarray:
    """The leaf at the reference's dtype: index leaves int32."""
    return x.astype(np.int32) if x.dtype == np.int64 else x


def fleet_flat(fleet: Fleet) -> Dict[str, np.ndarray]:
    """The fleet as ``{JAX key: numpy array}``, plus the port's generator
    states (uint8) under ``torch/...`` keys."""
    tree = fleet_to_numpy(fleet)
    tree.update(episode=np.asarray(tree["episode"], np.int32),
                rng=fleet.rng, pod_ids=dtp.to_numpy(fleet.pod_ids),
                group_ids={k: dtp.to_numpy(v)
                           for k, v in fleet.group_ids.items()})
    flat: Dict[str, np.ndarray] = {}

    def put(node, key, style):
        if style is None or not isinstance(node, dict):
            flat[key] = _jax_dtype(np.asarray(node))
            return
        for k, v in node.items():
            put(v, f"{key}/.{k}" if style == "attr" else f"{key}/{k}",
                style)
    for path, key, style in _LAYOUT:
        node = tree
        for p in path:
            node = node.get(p) if isinstance(node, dict) else None
        if node is not None:
            put(node, key, style)
    for key, attr in GENERATORS.items():
        gen = getattr(fleet, attr)
        if gen is not None:
            flat[key] = gen.get_state().numpy().copy()
    return flat


def _unflatten(flat: Mapping[str, np.ndarray]):
    """The ``fleet_to_numpy`` tree of a ``{JAX key: array}`` dict."""
    tree: Dict[str, Any] = {}
    for path, key, style in _LAYOUT:
        if key + "/" == HEALTH_KEY and not any(
                k.startswith(HEALTH_KEY) for k in flat):
            continue
        parent = tree
        for p in path[:-1]:
            parent = parent.setdefault(p, {})
        if style is None:
            parent[path[-1]] = flat[key]
            continue
        sub = parent.setdefault(path[-1], {})
        for k, v in flat.items():
            if not k.startswith(key + "/"):
                continue
            node = sub
            *inner, leaf = [s.lstrip(".") for s in
                            k[len(key) + 1:].split("/")]
            for s in inner:
                node = node.setdefault(s, {})
            node[leaf] = v
    tree["episode"] = int(tree["episode"])
    return tree


def _dtype_name(x: np.ndarray) -> str:
    return "bfloat16" if x.dtype == BF16 else str(x.dtype)


def save(ckpt_dir: str, step: int, state, extra: Optional[Dict] = None):
    """Write ``state`` (a ``Fleet`` or a ``{key: array}`` dict) as step
    ``step``: the arrays file, then its manifest, each through a temporary
    file renamed into place. Returns the arrays file's path. A meshed
    fleet is gathered whole (every rank calls ``save``) and written by
    rank 0; the other ranks return None."""
    if isinstance(state, Fleet) and state.placement is not None:
        rank = state.placement.rank
        state = fleet_gather(state)
        if rank != 0:
            return None
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = fleet_flat(state) if isinstance(state, Fleet) else dict(state)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    arrays_path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    os.replace(tmp, arrays_path)
    manifest = {
        "step": step,
        "arrays": os.path.basename(arrays_path),
        "keys": sorted(flat),
        # np.savez stores bf16 as raw void bytes: the true dtypes ride here
        "dtypes": {k: _dtype_name(v) for k, v in flat.items()},
        "extra": extra or {},
    }
    mtmp = arrays_path + ".manifest.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(ckpt_dir, f"step_{step:08d}.json"))
    return arrays_path


def _complete_steps(ckpt_dir: str):
    """Steps of every complete checkpoint: a parseable manifest whose
    arrays file exists and starts with a zip header."""
    steps = []
    for f in os.listdir(ckpt_dir):
        if not (f.startswith("step_") and f.endswith(".json")):
            continue
        try:
            step = int(f[len("step_"):-len(".json")])
        except ValueError:
            continue
        try:
            with open(os.path.join(ckpt_dir, f)) as fh:
                manifest = json.load(fh)
            with open(os.path.join(ckpt_dir, manifest["arrays"]), "rb") as fh:
                magic = fh.read(4)
        except (OSError, json.JSONDecodeError, KeyError, TypeError):
            continue
        if magic != b"PK\x03\x04":   # npz is a zip; torn writes fail here
            continue
        steps.append(step)
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def keep_last(ckpt_dir: str, n: int) -> int:
    """Remove all but the newest ``n`` complete checkpoints; returns how
    many were removed."""
    if n < 1:
        raise ValueError(f"keep_last needs n >= 1, got {n}")
    if not os.path.isdir(ckpt_dir):
        return 0
    doomed = _complete_steps(ckpt_dir)[:-n]
    for step in doomed:
        for suffix in (".npz", ".json"):
            try:
                os.remove(os.path.join(ckpt_dir, f"step_{step:08d}{suffix}"))
            except FileNotFoundError:
                pass
    return len(doomed)


def load(ckpt_dir: str, step: int):
    """The manifest and the open arrays file of step ``step``: a missing
    manifest raises ``FileNotFoundError`` naming the latest complete step,
    a corrupt manifest or arrays file a ``ValueError`` naming the file."""
    mpath = os.path.join(ckpt_dir, f"step_{step:08d}.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"no checkpoint manifest at {mpath} — wrong step or dir? "
            f"(latest complete step: {latest_step(ckpt_dir)})")
    except json.JSONDecodeError as e:
        raise ValueError(f"corrupt checkpoint manifest {mpath}: {e}")
    if not isinstance(manifest, dict) or "arrays" not in manifest:
        raise ValueError(f"corrupt checkpoint manifest {mpath}: missing "
                         f"'arrays' entry")
    apath = os.path.join(ckpt_dir, manifest["arrays"])
    try:
        data = np.load(apath)
        data.keys()   # read the zip directory here, so corruption fails here
    except FileNotFoundError:
        raise ValueError(
            f"checkpoint arrays file {apath} is missing (named by manifest "
            f"{mpath}; the dir is half-deleted) — restore an older step or "
            f"re-save")
    except Exception as e:   # zipfile.BadZipFile, OSError, pickle errors
        raise ValueError(f"corrupt checkpoint arrays file {apath}: {e}")
    return manifest, data


def _convert(arr: np.ndarray, saved: Optional[str], want: np.dtype,
             key: str) -> np.ndarray:
    """A stored leaf at the target's dtype. Raw 2-byte values are bf16
    (``saved`` names the true dtype; a pre-manifest save falls back to the
    target's when the widths agree): kept raw for a bf16 target, widened
    exactly for a wider one. A bf16 target rounds to nearest even."""
    if arr.dtype.kind == "V":
        if saved not in (None, "bfloat16") or arr.dtype.itemsize != 2 or (
                saved is None and want.itemsize != 2):
            raise ValueError(f"cannot decode void-dtype leaf {key} "
                             f"({arr.dtype}, saved as {saved}) into {want}")
        if want == BF16:
            return arr
        wide = arr.view(np.uint16).astype(np.uint32) << 16
        return wide.view(np.float32).astype(want)
    if want == BF16:
        return dtp.to_numpy(torch.from_numpy(np.ascontiguousarray(
            arr, np.float32)).to(torch.bfloat16))
    return arr.astype(want)


def _whole_shape(key: str, shape, place):
    """A leaf's shape in the whole fleet of a meshed one (``place``; the
    shape itself without one): the per-pod leaves (the base networks, the
    partition timer) lead with the pod count, the episode counter is a
    scalar, every other leaf leads with the agent count."""
    if place is None or not shape:
        return tuple(shape)
    pods = key == "12" or key.startswith("1/")
    return ((place.n_pods if pods else place.n_agents),) + tuple(shape[1:])


def restore(ckpt_dir: str, step: int, like: Fleet, cfg, seed: int = 0):
    """Step ``step`` restored into the layout and dtypes of ``like`` (a
    fleet on the device to restore to, e.g. one from ``fleet_init`` with
    the run's policy): every key of ``like`` must be in the checkpoint with
    its shape; keys it does not ask for are ignored, and each leaf is
    converted to ``like``'s dtype (bf16 widens exactly). The generators
    take the states the checkpoint holds for them when they fit this
    device's generator; otherwise the fleet's generator is seeded by
    ``seed``. A checkpoint without health state restores a health ``like``
    without it (``fleet.health`` None; the drivers attach fresh state).
    Returns (fleet, manifest); the manifest's ``restored_generators`` lists
    the generator keys restored. A meshed ``like`` gets the whole file's
    fleet sliced to its placement (no collective: the whole layout is
    ``like``'s own leaves at the whole fleet's leading sizes)."""
    place = like.placement
    manifest, data = load(ckpt_dir, step)
    has_health = any(k.startswith(HEALTH_KEY) for k in data.files)
    target = {k: (_whole_shape(k, v.shape, place), v.dtype)
              for k, v in fleet_flat(like).items()
              if k not in GENERATORS
              and (has_health or not k.startswith(HEALTH_KEY))}
    missing = [k for k in target if k not in data]
    if missing:
        raise ValueError(
            f"checkpoint/model structure mismatch: {len(missing)} leaves of "
            f"the restore target are absent from the checkpoint (e.g. "
            f"{missing[:3]}) — the checkpoint likely predates fields added "
            f"to the fleet state; re-save from a current run")
    dtypes = manifest.get("dtypes", {})
    flat = {}
    for key, (shape, dtype) in target.items():
        arr = data[key]
        if arr.shape != shape:
            raise ValueError(f"checkpoint/model shape mismatch at {key}: "
                             f"{arr.shape} vs {shape}")
        flat[key] = _convert(arr, dtypes.get(key), dtype, key)
    fleet = fleet_from_numpy(cfg, _unflatten(flat),
                             device=like.pod_ids.device, seed=seed)
    restored = []
    for key, attr in GENERATORS.items():
        if key not in data:
            continue
        gen = torch.Generator(device=like.pod_ids.device)
        state = torch.from_numpy(np.array(data[key], np.uint8))
        if state.numel() != gen.get_state().numel():
            continue      # another device's generator
        gen.set_state(state)
        setattr(fleet, attr, gen)
        restored.append(key)
    manifest["restored_generators"] = restored
    if place is not None:
        fleet = fleet_shard(fleet, place)
    return fleet, manifest


# ---------------------------------------------------------------------------
# Trees of tensors (the LM train state)
# ---------------------------------------------------------------------------
def _keyed(tree, prefix: str = ""):
    """(JAX key, tensor) of every tensor of a tree of dicts and lists:
    ``a/b/0/c`` for ``tree["a"]["b"][0]["c"]``."""
    if torch.is_tensor(tree):
        yield prefix, tree
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        yield from _keyed(v, f"{prefix}/{k}" if prefix else str(k))


def tree_flat(tree) -> Dict[str, np.ndarray]:
    """A tree of tensors as ``{JAX key: numpy array}`` (bf16 as raw
    ``|V2``), what ``save`` writes."""
    return {k: dtp.to_numpy(v) for k, v in _keyed(tree)}


def _np_dtype(t: torch.Tensor) -> np.dtype:
    if t.dtype == torch.bfloat16:
        return BF16
    return torch.empty((), dtype=t.dtype).numpy().dtype


def restore_tree(ckpt_dir: str, step: int, like):
    """Step ``step`` restored into the layout, dtypes and device of
    ``like`` (a tree of tensors, e.g. a fresh train state): every leaf of
    ``like`` must be in the checkpoint with its shape; keys it does not
    ask for are ignored. Returns (tree, manifest)."""
    manifest, data = load(ckpt_dir, step)
    dtypes = manifest.get("dtypes", {})
    missing = [k for k, _ in _keyed(like) if k not in data]
    if missing:
        raise ValueError(
            f"checkpoint/model structure mismatch: {len(missing)} leaves of "
            f"the restore target are absent from the checkpoint (e.g. "
            f"{missing[:3]})")
    leaves = {}
    for key, t in _keyed(like):
        arr = data[key]
        if arr.shape != tuple(t.shape):
            raise ValueError(f"checkpoint/model shape mismatch at {key}: "
                             f"{arr.shape} vs {tuple(t.shape)}")
        arr = _convert(arr, dtypes.get(key), _np_dtype(t), key)
        leaves[key] = dtp.from_numpy(arr, t.device).to(t.dtype)

    def build(node, prefix):
        if torch.is_tensor(node):
            return leaves[prefix]
        key = lambda k: f"{prefix}/{k}" if prefix else str(k)
        if isinstance(node, dict):
            return {k: build(v, key(k)) for k, v in node.items()}
        return type(node)(build(v, key(i)) for i, v in enumerate(node))
    return build(like, ""), manifest
