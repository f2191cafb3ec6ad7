"""Request-grade latency attribution: the flight recorder's per-request
layer.

Port of ``repro.obs.requests`` (numpy on the host, over the port's own
``SIM_*`` / ``CAP_*`` constants). The per-tick counter series comes from
``simulate_fleet(..., record_ticks=True)``, whose recording K3 writes it on
the card; ``attribute_run`` reads the final ``SimState``'s tensors through
``.cpu()``.

The twin's data plane is positional: every agent's five stage pointers
(``SIM_TAIL``/``SIM_PPRE``/``SIM_LAUNCH``/``SIM_PINF``/``SIM_HEAD``) are
monotone request counts, so admitted request ``q`` crossed stage ``S`` at
the first microtick whose post-tick pointer exceeds ``q``. Given the
per-tick counter series a ``simulate_fleet(..., record_ticks=True)`` run
emits, this module reconstructs every request's lifecycle stamps — admit ->
pre-done -> batch-launch -> infer-done -> complete — with a vectorized
``searchsorted`` per stage, no per-request Python.

From the stamps fall out the per-stage delay decomposition (queueing +
service at pre, batch-formation wait, inference, post) that explains WHERE
p99 goes, exact conservation checks against the twin's own aggregate
counters (completed / effective / lat_sum / histogram — property-tested in
tests/test_torch_attribution.py), and Chrome-trace slices on the twin's virtual
timeline (one ``pid`` per agent, one lane per pipeline stage).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.kernels.ref import (CAP_SLO, SIM_ARRIVED, SIM_COMPLETED,
                                     SIM_DROPPED, SIM_EFFECTIVE, SIM_HEAD,
                                     SIM_LAUNCH, SIM_PINF, SIM_PPRE,
                                     SIM_TAIL)

# lifecycle stamp columns (flat microtick index of each stage crossing)
STAGES = ("admit", "pre", "batch", "infer", "post")
_PTRS = (SIM_TAIL, SIM_PPRE, SIM_LAUNCH, SIM_PINF, SIM_HEAD)
# delay segments between consecutive stamps (ticks; +1 on the last for the
# end-of-tick completion convention: latency = head + 1 - tail)
SEGMENTS = ("pre_wait", "batch_wait", "infer", "post")


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def request_stamps(counters_seq: np.ndarray) -> np.ndarray:
    """Stage-crossing stamps for ONE agent. ``counters_seq``: (N_ticks,
    SIM_NCOUNTERS) int32 post-tick counter series (flattened over
    intervals). Returns (n_admitted, 5) int64 flat-tick stamps in STAGES
    order; -1 where the request never crossed that stage (still in
    flight)."""
    seq = np.asarray(counters_seq)
    n = int(seq[-1, SIM_TAIL]) if len(seq) else 0
    q = np.arange(n)
    stamps = np.empty((n, len(_PTRS)), np.int64)
    for j, ptr in enumerate(_PTRS):
        s = np.searchsorted(seq[:, ptr], q, side="right")
        stamps[:, j] = np.where(s < len(seq), s, -1)
    return stamps


def attribute_agent(counters_seq: np.ndarray, caps_seq: np.ndarray,
                    k_ticks: int) -> Dict[str, np.ndarray]:
    """Per-request attribution for ONE agent.

    ``counters_seq``: (T*K, SIM_NCOUNTERS) flat post-tick series;
    ``caps_seq``: (T, SIM_NCAPS) the held caps per control interval (the
    deadline check reads the SLO in force at the *completion* tick, exactly
    as ``sim_microtick`` does); ``k_ticks``: microticks per interval.

    Returns arrays over admitted requests: ``stamps`` (n, 5), ``completed``
    (bool), ``latency_ticks`` (−1 while in flight), ``effective`` (bool),
    and one ``<segment>_ticks`` array per SEGMENTS entry (−1 where the
    segment has not finished)."""
    stamps = request_stamps(counters_seq)
    caps_seq = np.asarray(caps_seq)
    completed = stamps[:, 4] >= 0
    lat = np.where(completed, stamps[:, 4] + 1 - stamps[:, 0], -1)
    slo = np.zeros(len(stamps), np.int64)
    if len(stamps) and len(caps_seq):
        iv = np.clip(stamps[:, 4] // k_ticks, 0, len(caps_seq) - 1)
        slo = caps_seq[iv, CAP_SLO].astype(np.int64)
    out: Dict[str, np.ndarray] = {
        "stamps": stamps,
        "completed": completed,
        "latency_ticks": lat,
        "effective": completed & (lat <= slo),
    }
    for j, seg in enumerate(SEGMENTS):
        a, b = stamps[:, j], stamps[:, j + 1]
        done = b >= 0
        # the completion segment lands end-of-tick: +1 (latency convention)
        d = b - a + (1 if seg == "post" else 0)
        out[seg + "_ticks"] = np.where(done, d, -1)
    return out


def conservation_report(attr: Dict[str, np.ndarray],
                        final_counters: np.ndarray,
                        final_lat_sum: float,
                        final_hist: Optional[np.ndarray] = None
                        ) -> Dict[str, Any]:
    """Check the reconstruction against the twin's own aggregates for one
    agent: admitted/completed/effective counts, the latency sum, and (when
    given) the completed-latency histogram must match EXACTLY — the stamps
    are a lossless decomposition, not an estimate."""
    c = np.asarray(final_counters)
    lat = attr["latency_ticks"][attr["completed"]]
    checks = {
        "admitted": (len(attr["stamps"]),
                     int(c[SIM_ARRIVED] - c[SIM_DROPPED])),
        "tail": (len(attr["stamps"]), int(c[SIM_TAIL])),
        "completed": (int(attr["completed"].sum()), int(c[SIM_COMPLETED])),
        "effective": (int(attr["effective"].sum()), int(c[SIM_EFFECTIVE])),
        "lat_sum": (int(lat.sum()), int(round(float(final_lat_sum)))),
    }
    if final_hist is not None:
        h = np.asarray(final_hist)
        got = np.bincount(np.clip(lat, 0, len(h) - 1), minlength=len(h))
        checks["hist"] = (got.tolist(), h.astype(np.int64).tolist())
    report = {k: {"reconstructed": a, "twin": b, "ok": a == b}
              for k, (a, b) in checks.items()}
    report["ok"] = all(v["ok"] for v in report.values())
    return report


def attribute_run(history: Dict[str, Any], state,
                  sample_every: int = 1) -> Dict[str, Any]:
    """Attribution for a whole ``simulate_fleet(..., record_ticks=True)``
    run. ``history`` must carry ``tick_counters`` (T, A, K, NCOUNTERS) and
    ``caps`` (T, A, NCAPS); ``state`` is the final (A,)-batched SimState
    (the port's: its tensors are read through ``.cpu()``).

    Returns ``{"agents": [per-agent attr dicts], "records": [sampled
    request dicts], "conservation": [per-agent reports]}`` — ``records``
    keeps every ``sample_every``-th admitted request per agent as a flat
    dict (CLI/JSON-friendly); the conservation checks always run on the
    full population."""
    ticks = _host(history["tick_counters"])  # (T, A, K, C)
    caps = _host(history["caps"])            # (T, A, NCAPS)
    lat_sum, hist = _host(state.lat_sum), _host(state.hist)
    t, a, k, c = ticks.shape
    agents, records, reports = [], [], []
    for i in range(a):
        seq = ticks[:, i].reshape(t * k, c)
        attr = attribute_agent(seq, caps[:, i], k)
        agents.append(attr)
        reports.append(conservation_report(
            attr, seq[-1] if len(seq) else np.zeros(c, np.int64),
            float(lat_sum[i]), hist[i]))
        for q in range(0, len(attr["stamps"]), max(int(sample_every), 1)):
            rec = {"agent": i, "request": q,
                   "completed": bool(attr["completed"][q]),
                   "effective": bool(attr["effective"][q]),
                   "latency_ticks": int(attr["latency_ticks"][q])}
            for j, s in enumerate(STAGES):
                rec[s + "_tick"] = int(attr["stamps"][q, j])
            for seg in SEGMENTS:
                rec[seg + "_ticks"] = int(attr[seg + "_ticks"][q])
            records.append(rec)
    return {"agents": agents, "records": records, "conservation": reports}


def stage_decomposition(agents: List[Dict[str, np.ndarray]],
                        dt: float) -> Dict[str, Dict[str, float]]:
    """Fleet-wide per-stage delay decomposition in SECONDS over completed
    requests: mean/p50/p99 of each segment, plus ``p99_tail_mean`` — the
    segment's mean over the requests at/beyond the p99 total latency (the
    "where does the tail go" column ``launch/simulate.py`` prints)."""
    segs = {s: [] for s in SEGMENTS}
    lats = []
    for attr in agents:
        done = attr["completed"]
        lats.append(attr["latency_ticks"][done])
        for s in SEGMENTS:
            segs[s].append(attr[s + "_ticks"][done])
    lat = (np.concatenate(lats) if lats else np.zeros(0, np.int64))
    out: Dict[str, Dict[str, float]] = {}
    tail = (lat >= np.percentile(lat, 99)) if len(lat) else None
    for s in SEGMENTS:
        v = (np.concatenate(segs[s]) if segs[s] else np.zeros(0, np.int64))
        if len(v) == 0:
            out[s] = {"mean_s": 0.0, "p50_s": 0.0, "p99_s": 0.0,
                      "p99_tail_mean_s": 0.0}
            continue
        out[s] = {
            "mean_s": float(v.mean() * dt),
            "p50_s": float(np.percentile(v, 50) * dt),
            "p99_s": float(np.percentile(v, 99) * dt),
            "p99_tail_mean_s": float(v[tail].mean() * dt) if tail is not None
            and tail.any() else 0.0,
        }
    return out


def records_to_chrome(tracer, records: List[Dict[str, Any]],
                      dt: float) -> int:
    """Append the sampled request lifecycles to ``tracer`` as Chrome-trace
    complete slices on the twin's VIRTUAL timeline (ts = microtick * dt,
    exported in µs): one trace pid per agent, one lane (tid) per pipeline
    segment. Returns the number of slices added."""
    n = 0
    for rec in records:
        if not rec["completed"]:
            continue
        pid = 1000 + rec["agent"]
        t0 = rec["admit_tick"]
        for lane, seg in enumerate(SEGMENTS):
            d = rec[seg + "_ticks"]
            if d < 0:
                continue
            tracer.add_complete(
                f"req{rec['request']}/{seg}",
                ts_us=t0 * dt * 1e6, dur_us=d * dt * 1e6, cat="request",
                pid=pid, tid=lane,
                args={"agent": rec["agent"], "request": rec["request"],
                      "effective": rec["effective"]})
            t0 += d
            n += 1
    return n
