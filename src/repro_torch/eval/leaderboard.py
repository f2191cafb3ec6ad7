"""Policy leaderboard: a checkpoint scored on every cell of the
scenario × backend × codec grid.

Port of ``repro.eval.leaderboard``. A **cell** is one point of the grid:
a workload (``repro_torch.sim.SCENARIOS``) × the environment the continual
cadence adapts in (fluid or twin) × the FL transport codec. Scoring a
checkpoint on a cell runs the production cadence: the checkpoint's fleet
(a copy, with fresh env states of the cell's backend) adapts over the
cell's scenario through ``train_fleet_scan`` under the cell codec, then
drives the request-level twin (``sim.harness.eval_fleet``) on a held-out
trace of the same scenario. Per cell and replicate: ``reward`` (tail mean
of the run history), ``train_eff``, the held-out ``eval_eff`` (req/s),
``eval_p99`` (s), ``eval_slo`` and the mean FL ``fl_payload_bytes``.

Each replicate's traces and action noise come from ``torch.Generator``s
seeded by ``cell_seed`` (a crc32 fold of the cell, never Python's salted
``hash``), so every cell is a pure function of (checkpoint, cell, seed,
shapes): two runs, or any ``n_jobs`` interleaving, give bit-identical rows.
The JAX package's PRNG draws cannot be reproduced here; ``evaluate_cell``
takes pre-drawn traces and noise instead (``draws``), the seam its parity
test uses.

``attach_deltas`` diffs new rows against a previous envelope and
``check_regressions`` turns the deltas into a gate. ``sanitize_envelope``
refuses an envelope from another backend; the port stamps its own as
``backend_stamp()`` (``"torch:cuda"`` / ``"torch:cpu"``), which never
equals a JAX envelope's backend, so a TPU or XLA envelope is refused as
cross-backend.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.backends import BACKENDS, get_backend
from repro_torch.core.fleet import (Fleet, fleet_from_numpy, fleet_init,
                                    fleet_to_numpy, train_fleet_scan)
from repro_torch.fl.transport import CODECS, TransportConfig
from repro_torch.sim import SCENARIOS, SimParams, make_scenario
from repro_torch.sim.harness import eval_fleet
from repro_torch.training import checkpoint as ckpt_mod

GRID_SCENARIOS: Tuple[str, ...] = SCENARIOS          # all 9 named workloads
GRID_BACKENDS: Tuple[str, ...] = BACKENDS            # fluid | twin
GRID_CODECS: Tuple[str, ...] = CODECS                # float32 | int8 | topk
REPLICATES = 3

# higher-is-better metrics the regression gate watches, with an absolute
# floor so that near-zero baselines do not make the relative tolerance a
# zero-width band (reward in [-1, 1]; throughput in req/s)
GATE_METRICS: Dict[str, float] = {"reward_mean": 0.05, "eval_eff_mean": 1.0}
DELTA_KEYS: Tuple[str, ...] = ("reward_mean", "eval_eff_mean",
                               "eval_p99_mean", "eval_slo_mean",
                               "fl_payload_bytes")
DEFAULT_TOL = 0.10
# hist_n=128 keeps the held-out p99 uncensored out to 6.35 s
EVAL_SP = SimParams(hist_n=128)


@dataclass(frozen=True)
class Cell:
    scenario: str
    backend: str
    codec: str

    @property
    def name(self) -> str:
        return f"leaderboard_{self.scenario}_{self.backend}_{self.codec}"


def grid_cells(scenarios: Sequence[str] = GRID_SCENARIOS,
               backends: Sequence[str] = GRID_BACKENDS,
               codecs: Sequence[str] = GRID_CODECS) -> List[Cell]:
    """The dense grid, scenario-major: the canonical leaderboard order."""
    return [Cell(s, b, c) for s in scenarios for b in backends
            for c in codecs]


def cell_seed(base_seed: int, cell: Cell, rep: int, tag: str = "") -> int:
    """Deterministic per-(cell, replicate, stream) seed (crc32)."""
    token = f"{cell.scenario}|{cell.backend}|{cell.codec}|{rep}|{tag}"
    return int((base_seed + zlib.crc32(token.encode())) % (2 ** 31 - 1))


def _with_env_states(cfg: FCPOConfig, fleet: Fleet, backend,
                     seed: int = 0) -> Fleet:
    """A copy of the checkpoint's fleet (policies, optimizers, buffers)
    with FRESH env states of the cell's backend and its generator seeded
    by ``seed``; the input fleet is left as it is (the drivers train in
    place). A fluid-trained checkpoint is evaluable in the twin and vice
    versa: the 8-dim observation has one definition."""
    dev = fleet.pod_ids.device
    copy = fleet_from_numpy(cfg, {**fleet_to_numpy(fleet), "rng": fleet.rng},
                            device=dev, seed=seed)
    copy.astate.env_state = backend.init(cfg, int(fleet.pod_ids.shape[0]),
                                         dev)
    return copy


def _generator(seed: int, device="cpu") -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def evaluate_cell(cfg: FCPOConfig, fleet: Fleet, cell: Cell, *,
                  episodes: int = 6, eval_intervals: int = 30,
                  replicates: int = REPLICATES, seed: int = 0,
                  sim_params: Optional[SimParams] = None,
                  eval_sp: SimParams = EVAL_SP,
                  draws: Optional[Callable[[int], Dict[str, Any]]] = None
                  ) -> Dict[str, Any]:
    """Score one checkpoint on one grid cell: per replicate, ``episodes``
    of the continual cadence (FL rounds under the cell codec) on the cell's
    scenario and backend, then a held-out twin evaluation. Returns the row:
    mean ± std over replicates of every metric and the raw per-replicate
    values (``*_reps``).

    ``draws(rep)``: optional pre-drawn inputs of replicate ``rep``, a dict
    with ``traces`` (A, episodes * n_steps), ``gumbel`` (episodes, A,
    n_steps, K) action noise, ``eval_traces`` (A, eval_intervals) and
    ``eval_gumbel`` (eval_intervals, A, K); without it the traces are drawn
    on the host from ``cell_seed`` streams and the noise from generators
    on the fleet's device seeded the same way."""
    backend = get_backend(cell.backend, sim_params=sim_params)
    transport = TransportConfig(codec=cell.codec)
    dev = fleet.pod_ids.device
    a = int(fleet.pod_ids.shape[0])
    tail = max(episodes // 2, 1)
    reps: Dict[str, List[float]] = {k: [] for k in
                                    ("reward", "train_eff", "eval_eff",
                                     "eval_p99", "eval_slo", "payload")}
    for r in range(replicates):
        s = cell_seed(seed, cell, r)
        d = draws(r) if draws is not None else {}
        f = _with_env_states(cfg, fleet, backend,
                             cell_seed(seed, cell, r, "noise"))
        traces = d.get("traces")
        if traces is None:
            traces = make_scenario(cell.scenario, _generator(s), a,
                                   episodes * cfg.n_steps, device=dev)
        f, hist = train_fleet_scan(cfg, f, torch.as_tensor(traces,
                                                           device=dev),
                                   env_backend=backend, transport=transport,
                                   seed=s, gumbel=d.get("gumbel"))
        fl_eps = np.flatnonzero(hist["fl_payload_bytes"])
        reps["reward"].append(float(np.mean(hist["reward"][-tail:])))
        reps["train_eff"].append(
            float(np.mean(hist["effective_throughput"][-tail:])))
        reps["payload"].append(
            float(hist["fl_payload_bytes"][fl_eps].mean()) if fl_eps.size
            else 0.0)

        ev = d.get("eval_traces")
        if ev is None:
            ev = make_scenario(cell.scenario,
                               _generator(cell_seed(seed, cell, r, "eval")),
                               a, eval_intervals, device=dev)
        gumbel = d.get("eval_gumbel")
        _, _, summ = eval_fleet(
            cfg, eval_sp, f, torch.as_tensor(ev, device=dev),
            gumbel=None if gumbel is None else torch.as_tensor(
                gumbel, device=dev),
            generator=_generator(cell_seed(seed, cell, r, "key"), dev))
        reps["eval_eff"].append(
            float(summ["effective_throughput"].float().mean()))
        reps["eval_p99"].append(float(summ["p99_latency_s"].float().mean()))
        reps["eval_slo"].append(float(summ["slo_attainment"].float().mean()))

    row: Dict[str, Any] = {
        "name": cell.name,
        "scenario": cell.scenario, "env_backend": cell.backend,
        "codec": cell.codec, "agents": a, "episodes": episodes,
        "eval_intervals": eval_intervals, "replicates": replicates,
        "seed": seed,
    }
    for key in ("reward", "train_eff", "eval_eff", "eval_p99", "eval_slo"):
        row[f"{key}_mean"] = float(np.mean(reps[key]))
        row[f"{key}_std"] = float(np.std(reps[key]))
        row[f"{key}_reps"] = reps[key]
    row["fl_payload_bytes"] = float(np.mean(reps["payload"]))
    return row


def run_leaderboard(cfg: FCPOConfig, fleet: Fleet,
                    cells: Optional[Iterable[Cell]] = None, *,
                    episodes: int = 6, eval_intervals: int = 30,
                    replicates: int = REPLICATES, seed: int = 0,
                    sim_params: Optional[SimParams] = None,
                    eval_sp: SimParams = EVAL_SP, n_jobs: int = 1,
                    log=None) -> List[Dict[str, Any]]:
    """Score a checkpoint over a cell list (default: the full grid).
    ``n_jobs`` round-robins the cells into that many stripes and evaluates
    stripe by stripe: a reordering only (each cell's seeds are its own, so
    the rows are bit-identical for any ``n_jobs``). Rows come back in the
    input cell order."""
    cells = list(grid_cells() if cells is None else cells)
    if n_jobs < 1:
        raise ValueError(f"n_jobs must be >= 1, got {n_jobs}")
    order = [i for j in range(n_jobs) for i in range(j, len(cells), n_jobs)]
    rows: Dict[int, Dict[str, Any]] = {}
    for i in order:
        rows[i] = evaluate_cell(cfg, fleet, cells[i], episodes=episodes,
                                eval_intervals=eval_intervals,
                                replicates=replicates, seed=seed,
                                sim_params=sim_params, eval_sp=eval_sp)
        if log is not None:
            r = rows[i]
            log(f"{r['name']}: reward={r['reward_mean']:+.3f} "
                f"eff={r['eval_eff_mean']:.2f}/s "
                f"p99={r['eval_p99_mean'] * 1e3:.0f}ms "
                f"slo={r['eval_slo_mean'] * 100:.0f}% "
                f"payload={r['fl_payload_bytes'] / 1024:.1f}KB")
    return [rows[i] for i in range(len(cells))]


# ---------------------------------------------------------------------------
# Envelope deltas and the regression gate
# ---------------------------------------------------------------------------
# fields that must agree between a row and its previous measurement for the
# comparison to mean anything
COMPAT_KEYS: Tuple[str, ...] = ("agents", "episodes", "eval_intervals",
                                "replicates", "seed")


def backend_stamp() -> Dict[str, Any]:
    """The envelope stamp of this process: ``torch:cuda`` with the visible
    card count, or ``torch:cpu`` and 1."""
    if torch.cuda.is_available():
        return {"backend": "torch:cuda",
                "device_count": torch.cuda.device_count()}
    return {"backend": "torch:cpu", "device_count": 1}


def sanitize_envelope(prev_envelope, warn=None):
    """The previous envelope when usable (a dict whose ``results`` is a
    list), else None with a warning. An envelope stamped with another
    backend or device count is refused as cross-backend (a JAX envelope's
    ``cpu`` / ``gpu`` / ``tpu`` never equals ``torch:...``); an unstamped
    one passes. ``warn`` is an optional ``print``-like callable."""
    if prev_envelope is None:
        return None
    if (not isinstance(prev_envelope, dict)
            or not isinstance(prev_envelope.get("results"), list)):
        if warn is not None:
            warn("leaderboard: previous envelope is not a results envelope "
                 "— treating as no baseline")
        return None
    for key, cur in backend_stamp().items():
        prev = prev_envelope.get(key)
        if prev is not None and prev != cur:
            if warn is not None:
                warn(f"leaderboard: previous envelope is from {key}="
                     f"{prev!r} but this run is {key}={cur!r} — refusing "
                     f"the cross-backend diff, treating as no baseline")
            return None
    return prev_envelope


def _compatible(row, prev) -> bool:
    return all(prev.get(k) == row.get(k) for k in COMPAT_KEYS)


def attach_deltas(rows: List[Dict[str, Any]],
                  prev_envelope: Optional[Dict[str, Any]],
                  warn=None) -> List[Dict[str, Any]]:
    """Fold the previous envelope into ``rows`` (in place): for every cell
    in both, ``prev_<k>`` and ``delta_<k>`` (new − prev) for each
    ``DELTA_KEYS`` metric. Cells without a previous measurement, with an
    incompatible one (``COMPAT_KEYS``) or with a torn / non-numeric value
    carry no delta; an unusable envelope (``sanitize_envelope``) none."""
    prev_envelope = sanitize_envelope(prev_envelope, warn)
    prev_rows = {r["name"]: r
                 for r in (prev_envelope or {}).get("results", [])
                 if isinstance(r, dict) and "name" in r}
    for row in rows:
        prev = prev_rows.get(row["name"])
        if prev is None:
            continue
        if not _compatible(row, prev):
            if warn is not None:
                diffs = [k for k in COMPAT_KEYS
                         if prev.get(k) != row.get(k)]
                warn(f"leaderboard: {row['name']} previous row is from an "
                     f"incompatible grid ({', '.join(diffs)} changed) — "
                     f"no baseline for this cell")
            continue
        for k in DELTA_KEYS:
            if k in prev and k in row:
                try:
                    pv, nv = float(prev[k]), float(row[k])
                except (TypeError, ValueError):
                    continue
                if not np.isfinite(pv):
                    continue
                row[f"prev_{k}"] = pv
                row[f"delta_{k}"] = nv - pv
    return rows


def check_regressions(rows: List[Dict[str, Any]], tol: float = DEFAULT_TOL,
                      tolerances: Optional[Dict[str, float]] = None
                      ) -> List[str]:
    """One failure string per (cell, gated metric) whose new value fell
    more than ``tol * max(|prev|, floor)`` below the previous one
    (``tolerances[cell name]`` overrides ``tol``). Rows without ``prev_*``
    fields never fail. Call ``attach_deltas`` first."""
    failures = []
    for row in rows:
        if not isinstance(row, dict) or "name" not in row:
            continue
        cell_tol = (tolerances or {}).get(row["name"], tol)
        for metric, floor in GATE_METRICS.items():
            prev_key = f"prev_{metric}"
            if prev_key not in row or metric not in row:
                continue
            try:
                prev, new = float(row[prev_key]), float(row[metric])
            except (TypeError, ValueError):
                continue
            if not (np.isfinite(prev) and np.isfinite(new)):
                continue
            allowed = cell_tol * max(abs(prev), floor)
            if prev - new > allowed:
                failures.append(
                    f"{row['name']}: {metric} regressed {prev:.4f} -> "
                    f"{new:.4f} (drop {prev - new:.4f} > allowed "
                    f"{allowed:.4f} at tol {cell_tol:.0%})")
    return failures


# ---------------------------------------------------------------------------
# Checkpoint loading
# ---------------------------------------------------------------------------
def load_fleet(cfg: FCPOConfig, ckpt_dir: str, step: Optional[int] = None, *,
               n_agents: int, n_pods: int = 1, env_backend=None,
               device="cuda") -> Fleet:
    """A fleet checkpoint (``training/checkpoint.py``, either package's) on
    ``device`` for leaderboard evaluation, the latest step by default.
    ``env_backend`` must be the backend the checkpoint was saved with (its
    env-state leaves are part of the stored layout)."""
    if step is None:
        step = ckpt_mod.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint manifests in {ckpt_dir}")
    like = fleet_init(cfg, n_agents, 0, n_pods=n_pods, device=device,
                      env_backend=env_backend)
    fleet, _manifest = ckpt_mod.restore(ckpt_dir, step, like, cfg)
    return fleet
