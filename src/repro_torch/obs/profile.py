"""Cost and memory accounting: the flight recorder's static layer.

Port of ``repro.obs.profile`` for what the port runs. Where the JAX package
reads XLA's analyses of the compiled scan, this module counts the graph
driver's own bodies, under the JAX package's function and field names
wherever the quantity is the same:

* ``profile_fleet_scan``: one ``FleetScan`` on a copy of the fleet.
  ``flops`` from ``torch.utils.flop_counter.FlopCounterMode`` over one
  eager episode body and one eager FL-round body; ``bytes_accessed``: the
  input plus output bytes of every op those bodies dispatch, plus the
  hand-written kernels' bytes (``kernel_cost`` per launch) — an upper
  bound on what the card moves (an op's operands may come from L2), as
  XLA's ``bytes accessed`` is an estimate; ``argument_size_in_bytes``
  (the fleet's state and the staged inputs), ``output_size_in_bytes`` (the
  history rows), ``peak_bytes`` and ``temp_size_in_bytes`` (the peak less
  arguments and outputs): on the card from ``max_memory_allocated`` around
  the run's capture and replays (graph pools included), on the CPU from
  the high-water mark of the tensors the counted bodies' ops return,
  added to the arguments and outputs. There is no counterpart of XLA's
  ``generated_code_size_in_bytes``: the port runs PyTorch's precompiled
  kernels and its own, not a generated program.
* ``donation_audit``: the port updates the fleet in place where JAX
  donates it; the audit counts the fleet's leaves whose storage is the
  same after the run (``aliased_args``) against the leaf count
  (``expected_donated``).
* ``fleet_memory_report``: per state policy, the state bytes by family
  (``fleet_state_bytes``) beside ``profile_fleet_scan``'s numbers.
* ``kernel_cost`` / ``profile_kernels``: each kernel's operations and
  bytes (each input read once, each output written once) from its shapes:
  the counts of the bound column of PERF.md and ``chip_smoke.py``.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import resolve_device
from repro_torch.core import dtypes as dtp
from repro_torch.kernels.ref import SIM_NCAPS, SIM_NCOUNTERS

F32 = 4


# ---------------------------------------------------------------------------
# The kernels' operations and bytes, from their shapes
# ---------------------------------------------------------------------------
def nbytes(*xs) -> int:
    """Storage bytes of the tensors ``xs``."""
    return sum(x.numel() * x.element_size() for x in xs)


def k1_flops_per_candidate(cfg) -> int:
    """K1's float operations for one candidate of one agent (Eq. 6: the
    covariance, its Cholesky factor and solve, the Mahalanobis norm, the
    clipped KL against every slot, the argmin, the rank-1 update)."""
    d, na, n = cfg.state_dim, cfg.n_res + cfg.n_bs + cfg.n_mt, \
        cfg.buffer_size
    chol = d ** 3 // 3 + 2 * d * d        # factor
    return (3 * d * d + chol + d * d + 2 * d   # cov, factor, solve, norm
            + 6 * na                           # clipped KL
            + n                                # argmin
            + 4 * d * d + 4 * d + 4 * na)      # rank-1 add/subtract


def attention_flops(b: int, hq: int, sq: int, sk: int, d: int,
                    causal: bool) -> int:
    """Multiply-adds (x2) of attention's two products over the (query,
    key) pairs it scores: K4 at sq = sk, K5 at sq = 1."""
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    return 4 * b * hq * pairs * d


def kernel_cost(name: str, **s) -> Dict[str, float]:
    """``{"flops", "bytes_accessed"}`` of one launch of kernel ``name`` at
    the shapes ``s`` (each input read once, each output written once).
    diversity_insert: a, n, d, na, t (and ``flops_per_candidate``);
    delta_codec: a, lengths (the leaves' row lengths); queue_advance: a,
    ring, hist, k, record; flash_attention: b, s, hq, hkv, d, causal,
    itemsize; decode_attention: b, hq, hkv, d, kv_len, itemsize (the
    cache's) and q_itemsize; pack:
    n, distinct, row_bytes; span_stamp: none."""
    if name == "diversity_insert":
        a, n, d, na, t = s["a"], s["n"], s["d"], s["na"], s["t"]
        # states, probs, score, s_sum, s_outer, p_sum, n_filled; filled
        state = a * ((n * d + n * na + n + d + d * d + na + 1) * F32 + n)
        cand = a * t * (d + na) * F32
        trace = a * t * (F32 + 1 + F32)              # slot, do, d
        return {"flops": float(a * t * s["flops_per_candidate"]),
                "bytes_accessed": float(2 * state + cand + trace)}
    if name == "delta_codec":   # delta, residual in; decoded, residual out
        return {"flops": 0.0, "bytes_accessed":
                float(4 * F32 * s["a"] * sum(s["lengths"]))}
    if name == "queue_advance":
        a, k = s["a"], s["k"]
        state = a * (s["ring"] + SIM_NCOUNTERS + 2 + 1 + s["hist"]) * F32
        ins = state + a * (k + SIM_NCAPS) * F32
        ticks = a * k * SIM_NCOUNTERS * F32 if s.get("record") else 0
        return {"flops": 0.0, "bytes_accessed": float(ins + state + ticks)}
    if name == "flash_attention":
        b, sq, hq, hkv, d = s["b"], s["s"], s["hq"], s["hkv"], s["d"]
        q = b * sq * hq * d * s["itemsize"]
        kv = 2 * b * sq * hkv * d * s["itemsize"]
        return {"flops": float(attention_flops(b, hq, sq, sq, d,
                                               s["causal"])),
                "bytes_accessed": float(2 * q + kv)}
    if name == "decode_attention":   # q_itemsize, else the cache's
        b, hq, hkv, d, n = s["b"], s["hq"], s["hkv"], s["d"], s["kv_len"]
        q = b * hq * d * s.get("q_itemsize", s["itemsize"])
        return {"flops": float(attention_flops(b, hq, 1, n, d, False)),
                "bytes_accessed": float(2 * q + 2 * b * n * hkv * d
                                        * s["itemsize"])}
    if name == "pack":
        return {"flops": 0.0, "bytes_accessed": float(
            (s["n"] + s["distinct"]) * s["row_bytes"] + s["n"] * 4)}
    if name == "span_stamp":    # the episode and the period in, a stamp out
        return {"flops": 0.0, "bytes_accessed": 24.0}
    raise KeyError(name)


# the JAX package's canonical workload shapes (repro/obs/profile.py)
def _canonical(name: str) -> Dict[str, Any]:
    from repro_torch.configs.fcpo import FCPOConfig
    from repro_torch.sim.state import SimParams
    if name == "flash_attention":
        return dict(b=2, s=128, hq=4, hkv=4, d=64, causal=True, itemsize=F32)
    if name == "decode_attention":
        return dict(b=2, hq=4, hkv=4, d=64, kv_len=256, itemsize=F32)
    if name == "pack":   # indices [0, 63, -1, 5, 5, -1, 17, 2] of 64 rows
        return dict(n=8, distinct=5, row_bytes=128 * F32)
    if name == "diversity_insert":
        cfg = FCPOConfig(buffer_size=8)
        return dict(a=4, n=cfg.buffer_size, d=cfg.state_dim,
                    na=cfg.n_res + cfg.n_bs + cfg.n_mt, t=20,
                    flops_per_candidate=k1_flops_per_candidate(cfg))
    if name == "delta_codec":
        return dict(a=8, lengths=(3121,))
    if name == "queue_advance":
        sp = SimParams()
        return dict(a=4, ring=sp.ring, hist=sp.hist_n, k=sp.k_ticks)
    raise KeyError(name)


KERNELS = ("flash_attention", "decode_attention", "pack", "diversity_insert",
           "delta_codec", "queue_advance")


def profile_kernels(names=None) -> Dict[str, Dict[str, float]]:
    """Each kernel's ``flops`` and ``bytes_accessed`` at the JAX package's
    canonical workload shape, counted from the shapes (``kernel_cost``).
    ``names``: a subset (default: the six)."""
    return {n: kernel_cost(n, **_canonical(n)) for n in KERNELS
            if names is None or n in names}


# ---------------------------------------------------------------------------
# The graph driver's bodies
# ---------------------------------------------------------------------------
class OpBytes(TorchDispatchMode):
    """Counts the non-view ops dispatched in the block (``ops``), their
    input plus output bytes (``bytes``), and the high-water mark of the
    bytes of the tensors they return that are still alive (``peak``; an
    output that is one of the op's inputs, an in-place op's, is not new)."""

    def __init__(self):
        super().__init__()
        self.ops = self.bytes = self.live = self.peak = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func is torch.ops.aten.detach.default:
            return out
        ins = [x for x in tree_leaves((args, kwargs)) if torch.is_tensor(x)]
        outs = [x for x in tree_leaves(out) if torch.is_tensor(x)]
        self.ops += 1
        self.bytes += nbytes(*ins, *outs)
        seen = {x.data_ptr() for x in ins}
        for x in outs:
            if x.data_ptr() in seen:
                continue
            seen.add(x.data_ptr())
            n = nbytes(x)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(x, self._free, n)
        return out

    def _free(self, n: int) -> None:
        self.live -= n


def fleet_leaves(fleet):
    """The fleet's tensors (its state, the index leaves, the health state),
    in a fixed order."""
    out = []
    a = fleet.astate
    dtp.tree_map(out.append, (a.policy.params(), a.opt, a.buffer,
                              a.env_state, fleet.base.params(),
                              fleet.env_params, fleet.masks, fleet.group_ids,
                              fleet.pod_ids, fleet.bandwidth, fleet.speeds,
                              fleet.residuals, fleet.pending,
                              fleet.crash_timer, fleet.partition_timer,
                              () if fleet.health is None else fleet.health))
    return out


def donation_audit(ptrs_before, fleet_after) -> Dict[str, Any]:
    """The in-place audit: ``ptrs_before`` are the storage addresses of
    ``fleet_leaves`` before a run, ``fleet_after`` the fleet after it.
    ``aliased_args``: leaves whose storage is the same (updated in place,
    what JAX's donation aliases); ``expected_donated``: the leaf count;
    ``ok`` when every leaf was."""
    after = [x.data_ptr() for x in fleet_leaves(fleet_after)]
    aliased = sum(a == b for a, b in zip(ptrs_before, after))
    return {"aliased_args": aliased, "expected_donated": len(ptrs_before),
            "ok": aliased == len(ptrs_before) == len(after)}


def _kernel_bytes(cfg, fleet, launches, k_ticks: int) -> float:
    """Bytes of the hand-written kernels launched in the counted bodies
    (``launches``: K1, K2, K3 counts; ``k_ticks``: the twin's K)."""
    a = int(fleet.pod_ids.shape[0])
    k1 = kernel_cost("diversity_insert", a=a, n=cfg.buffer_size,
                     d=cfg.state_dim, na=cfg.n_res + cfg.n_bs + cfg.n_mt,
                     t=cfg.n_steps, flops_per_candidate=0)
    lengths = [p[0].numel() for p in fleet.astate.policy.params().values()]
    k2 = kernel_cost("delta_codec", a=a, lengths=lengths)
    total = launches[0] * k1["bytes_accessed"] + \
        launches[1] * k2["bytes_accessed"]
    sim = getattr(fleet.astate.env_state, "sim", None)
    if launches[2] and sim is not None:
        k3 = kernel_cost("queue_advance", a=a, ring=sim.arrive.shape[1],
                         hist=sim.hist.shape[1],
                         k=k_ticks)
        total += launches[2] * k3["bytes_accessed"]
    return float(total)


def profile_fleet_scan(cfg, fleet, traces, **kw) -> Dict[str, Any]:
    """Run one ``FleetScan`` over ``traces`` on a copy of ``fleet`` (its
    device; ``kw``: the driver's keyword arguments) and return its cost and
    memory accounting (module docstring) with the in-place audit:
    ``flops``, ``bytes_accessed``, ``ops``, ``argument_size_in_bytes``,
    ``output_size_in_bytes``, ``peak_bytes``, ``temp_size_in_bytes``,
    ``donated_leaves``, ``aliased_args``, ``donation_ok``, ``device``."""
    from repro_torch.core.fleet import (FleetScan, fleet_from_numpy,
                                        fleet_to_numpy)
    from repro_torch.core.graphs import full_float32
    from repro_torch.kernels.delta_codec import delta_codec
    from repro_torch.kernels.diversity import diversity_insert
    from repro_torch.kernels.queue_advance import queue_advance
    dev = fleet.pod_ids.device
    cuda = dev.type == "cuda"
    copy = lambda: fleet_from_numpy(cfg, fleet_to_numpy(fleet), device=dev)
    wrappers = (diversity_insert, delta_codec, queue_advance)

    # operations and bytes of one eager episode body and one round body
    counted = FleetScan(cfg, copy(), traces, **kw)
    before = [fn.launches for fn in wrappers]
    with torch.no_grad(), full_float32(), FlopCounterMode(display=False) \
            as flops, OpBytes() as ops:
        counted._episode()
        counted._round()
    launches = [fn.launches - n for fn, n in zip(wrappers, before)]
    sp = getattr(counted.backend, "sp", None)
    k_bytes = _kernel_bytes(cfg, counted.fleet, launches,
                            0 if sp is None else sp.k_ticks)
    args = nbytes(*fleet_leaves(counted.fleet)) + nbytes(
        *(x for x in (counted.rates, counted.avail, counted.gumbel,
                      *counted.plan) if x is not None),
        *(() if counted.byz_noise is None else counted.byz_noise.values()))
    outs = nbytes(*counted.rows)
    del counted

    # the memory of a whole run
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        run_fleet = copy()
        ptrs = [x.data_ptr() for x in fleet_leaves(run_fleet)]
        FleetScan(cfg, run_fleet, traces, **kw).run()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev) - base
    else:
        run_fleet = copy()
        ptrs = [x.data_ptr() for x in fleet_leaves(run_fleet)]
        FleetScan(cfg, run_fleet, traces, **kw).run()
        peak = args + outs + ops.peak
    audit = donation_audit(ptrs, run_fleet)
    return {"flops": float(flops.get_total_flops()),
            "bytes_accessed": float(ops.bytes) + k_bytes,
            "ops": float(ops.ops),
            "argument_size_in_bytes": float(args),
            "output_size_in_bytes": float(outs),
            "peak_bytes": float(peak),
            "temp_size_in_bytes": float(max(peak - args - outs, 0)),
            "donated_leaves": float(audit["expected_donated"]),
            "aliased_args": float(audit["aliased_args"]),
            "donation_ok": float(audit["ok"]),
            "device": dev.type}


def fleet_memory_report(cfg, n_agents: int, *, n_pods: int = 8,
                        n_episodes: int = 2,
                        state_policies=("float32", "lean"), seed: int = 0,
                        device="cuda", **kw) -> Dict[str, Dict[str, float]]:
    """Memory accounting of the graph driver at scale, per state policy:
    an ``n_agents`` fleet (``fleet_init(..., state_policy=...)``) on
    ``device``, ``profile_fleet_scan`` over ``n_episodes`` episodes of
    uniform(10, 50) traces from ``seed`` (numpy), and the stored-state
    bytes by family (``fleet_state_bytes``, as ``state_*``). Keys are
    policy names; each row adds ``peak_bytes_per_agent``. ``kw``: the
    driver's keyword arguments."""
    from repro_torch.core.dtypes import get_policy
    from repro_torch.core.fleet import fleet_init, fleet_state_bytes
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    traces = torch.as_tensor(rng.uniform(
        10.0, 50.0, (n_agents, n_episodes * cfg.n_steps)).astype(np.float32),
        device=dev)
    out: Dict[str, Dict[str, float]] = {}
    for pol in state_policies:
        name = get_policy(pol).name
        fleet = fleet_init(cfg, n_agents, seed, n_pods=n_pods, device=dev,
                           state_policy=pol)
        row = {f"state_{k}": v for k, v in fleet_state_bytes(fleet).items()}
        row.update(profile_fleet_scan(cfg, fleet, traces, **kw))
        row["peak_bytes_per_agent"] = row["peak_bytes"] / n_agents
        out[name] = row
        del fleet
    return out

