"""Request-grade latency attribution of the port on the CPU.

The recording data plane (``sim_interval_recorded``: K3's plain version
with ``record=True`` here) against ``jax.vmap(repro.sim.step.
sim_interval_recorded)`` on random states — tick series exact, state bit
for bit — and ``simulate_fleet(record_ticks=True)`` against JAX's at JAX's
fixture size (A=2, T=8, the ``steady`` scenario) on JAX's noise: the tick
series and caps exact, the attribution's stamps, records and conservation
reports equal to JAX's, the stage table's text equal to JAX's. Then the
conservation property over random workloads (hypothesis, ~10 examples, and
a fixed slice), the Chrome export, and ``simulate --attribution`` /
``--trace-out`` on ``--device cpu``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core.fleet import fleet_init as j_fleet_init
from repro.obs import requests as jreq
from repro.sim import harness as jharness
from repro.sim import make_scenario as j_make_scenario
from repro.sim import metrics as jmetrics
from repro.sim import step as jstep
from repro.sim.state import SimParams as JSimParams
from repro.sim.state import SimState as JSimState
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import env as tenv
from repro_torch.core.agent import ActionMask, tensors_from_numpy
from repro_torch.kernels.ref import (CAP_BATCH, CAP_POST, CAP_PRE, CAP_QCAP,
                                     CAP_SLO, CAP_TBATCH)
from repro_torch.launch import simulate as sim_cli
from repro_torch.obs import requests as treq
from repro_torch.obs.trace import Tracer, validate_chrome_trace
from repro_torch.sim import harness as tharness
from repro_torch.sim import metrics as tmetrics
from repro_torch.sim.state import SimParams, SimState, sim_init
from repro_torch.sim.step import sim_interval, sim_interval_recorded
from test_torch_support import exact, head_sizes, jax_sim_noise, np_tree

SEED = 0


def random_caps(rng, a):
    caps = np.zeros((a, 6), np.float32)
    caps[:, CAP_PRE] = rng.uniform(0.2, 4.0, a)
    caps[:, CAP_POST] = rng.uniform(0.2, 4.0, a)
    caps[:, CAP_BATCH] = rng.integers(1, 7, a)
    caps[:, CAP_TBATCH] = rng.integers(1, 7, a)
    caps[:, CAP_QCAP] = rng.integers(2, 13, a)
    caps[:, CAP_SLO] = rng.integers(1, 15, a)
    return caps


# ---------------------------------------------------------------------------
# The recording data plane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim_interval_recorded_matches_jax(seed):
    """Six chained intervals of random arrivals and caps (A=5, K=8, a ring
    of 64): JAX's vmapped recorded advance and the port's give the same
    tick series and state, and the recorded state is ``sim_interval``'s."""
    rng = np.random.default_rng(seed)
    a, k = 5, 8
    sp = SimParams(dt=0.05, k_ticks=k, ring=64, hist_n=16)
    jsp = JSimParams(dt=0.05, k_ticks=k, ring=64, hist_n=16)
    from repro.sim.state import sim_init as j_sim_init
    js = jax.vmap(lambda _: j_sim_init(jsp))(jnp.arange(a))
    ts = sim_init(sp, a, "cpu")
    step = jax.jit(jax.vmap(jstep.sim_interval_recorded))
    for _ in range(6):
        arrivals = rng.integers(0, 7, (a, k)).astype(np.int32)
        caps = random_caps(rng, a)
        js, jticks = step(js, jnp.asarray(arrivals), jnp.asarray(caps))
        plain = sim_interval(ts, torch.tensor(arrivals), torch.tensor(caps))
        ts, tticks = sim_interval_recorded(ts, torch.tensor(arrivals),
                                           torch.tensor(caps))
        assert tticks.shape == (a, k, 12) and tticks.dtype == torch.int32
        exact(tticks, jticks, "ticks")
        for name, got, want in zip(JSimState._fields, ts.tensors(),
                                   plain.tensors()):
            assert torch.equal(got, want), name
            exact(got, getattr(js, name), name)
        exact(tticks[:, -1], ts.counters, "last tick")


# ---------------------------------------------------------------------------
# A recorded run against JAX's (JAX's fixture: A=2, T=8)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def recorded_run():
    cfg = JCfg()
    a, t = 2, 8
    jf = j_fleet_init(cfg, a, jax.random.PRNGKey(SEED))
    traces = np.asarray(j_make_scenario("steady",
                                        jax.random.PRNGKey(SEED + 2), a, t))
    key = jax.random.PRNGKey(SEED + 3)
    j_state, j_hist, _ = jharness.simulate_fleet(
        cfg, JSimParams(), jf.astate.params, jf.masks, jf.env_params,
        jnp.asarray(traces), key, record_ticks=True)
    masks = ActionMask(*(torch.tensor(np.asarray(getattr(jf.masks, k)))
                         for k in ("res", "bs", "mt")))
    tep = tenv.EnvParams(**{k: torch.tensor(np.asarray(v))
                            for k, v in jf.env_params._asdict().items()})
    args = (TCfg(), SimParams(), tensors_from_numpy(np_tree(jf.astate.params),
                                                    "cpu"),
            masks, tep, torch.tensor(traces))
    gumbel = torch.tensor(np.asarray(jax_sim_noise(key, t, a,
                                                   head_sizes(cfg))))
    plain = tharness.simulate_fleet(*args, gumbel=gumbel)
    rec = tharness.simulate_fleet(*args, gumbel=gumbel, record_ticks=True)
    return {"sp": SimParams(), "j_state": j_state, "j_hist": j_hist,
            "plain": plain, "rec": rec}


def test_recording_is_bit_identical(recorded_run):
    (s0, h0, _), (s1, h1, _) = recorded_run["plain"], recorded_run["rec"]
    for name, x, y in zip(JSimState._fields, s0.tensors(), s1.tensors()):
        assert torch.equal(x, y), name
        exact(y, getattr(recorded_run["j_state"], name), name)
    for k, v in h0.items():
        np.testing.assert_array_equal(h1[k], v, err_msg=k)


def test_tick_series_and_caps_match_jax(recorded_run):
    hist, want = recorded_run["rec"][1], recorded_run["j_hist"]
    assert hist["tick_counters"].shape == (8, 2, 20, 12)
    exact(hist["tick_counters"], want["tick_counters"], "tick_counters")
    exact(hist["caps"], want["caps"], "caps")


@pytest.mark.parametrize("sample_every", [1, 4])
def test_attribution_matches_jax(recorded_run, sample_every):
    state, hist, _ = recorded_run["rec"]
    got = treq.attribute_run(hist, state, sample_every=sample_every)
    want = jreq.attribute_run(recorded_run["j_hist"],
                              recorded_run["j_state"],
                              sample_every=sample_every)
    assert got["records"] == want["records"]
    assert got["conservation"] == want["conservation"]
    assert all(rep["ok"] for rep in got["conservation"])
    for ga, wa in zip(got["agents"], want["agents"]):
        assert set(ga) == set(wa)
        for k in wa:
            np.testing.assert_array_equal(ga[k], wa[k], err_msg=k)


def test_segments_telescope_to_latency(recorded_run):
    state, hist, _ = recorded_run["rec"]
    for attr in treq.attribute_run(hist, state)["agents"]:
        done = attr["completed"]
        total = sum(attr[s + "_ticks"][done] for s in treq.SEGMENTS)
        assert np.array_equal(total, attr["latency_ticks"][done])


def test_stage_table_text_equals_jax(recorded_run):
    sp = recorded_run["sp"]
    state, hist, _ = recorded_run["rec"]
    got = treq.stage_decomposition(treq.attribute_run(hist, state)["agents"],
                                   sp.dt)
    want = jreq.stage_decomposition(jreq.attribute_run(
        recorded_run["j_hist"], recorded_run["j_state"])["agents"], sp.dt)
    assert got == want
    text = tmetrics.stage_breakdown_table(got)
    assert text == jmetrics.stage_breakdown_table(want)
    assert text.splitlines()[0].split() == ["stage", "mean", "p50", "p99",
                                            "p99-tail"]
    assert treq.STAGES == jreq.STAGES and treq.SEGMENTS == jreq.SEGMENTS


def test_records_export_to_valid_chrome_slices(recorded_run):
    state, hist, _ = recorded_run["rec"]
    out = treq.attribute_run(hist, state, sample_every=4)
    with Tracer() as tr:
        n = treq.records_to_chrome(tr, out["records"], recorded_run["sp"].dt)
        trace = tr.chrome_trace()
    assert n > 0 and validate_chrome_trace(trace) == []
    assert sum(1 for e in trace["traceEvents"] if e["ph"] == "X") == n
    jout = jreq.attribute_run(recorded_run["j_hist"], recorded_run["j_state"],
                              sample_every=4)
    from repro.obs.trace import Tracer as JTracer
    jt = JTracer()
    assert jreq.records_to_chrome(jt, jout["records"],
                                  recorded_run["sp"].dt) == n
    assert jt.chrome_events() == trace["traceEvents"]
    jt.close()


def test_sampling_thins_records_not_conservation(recorded_run):
    state, hist, _ = recorded_run["rec"]
    full = treq.attribute_run(hist, state, sample_every=1)
    thin = treq.attribute_run(hist, state, sample_every=8)
    assert 0 < len(thin["records"]) < len(full["records"])
    assert all(rep["ok"] for rep in thin["conservation"])


# ---------------------------------------------------------------------------
# Conservation over arbitrary workloads
# ---------------------------------------------------------------------------
def conserve(seed, n_intervals, k_ticks=8):
    """One agent through ``n_intervals`` random intervals of the recorded
    advance: the reconstruction conserves the twin's counters exactly."""
    rng = np.random.default_rng(seed)
    sp = SimParams(dt=0.05, k_ticks=k_ticks, ring=64, hist_n=16)
    state = sim_init(sp, 1, "cpu")
    seqs, caps_seq = [], []
    for _ in range(n_intervals):
        caps = random_caps(rng, 1)
        arrivals = rng.integers(0, 7, (1, k_ticks)).astype(np.int32)
        state, ticks = sim_interval_recorded(state, torch.tensor(arrivals),
                                             torch.tensor(caps))
        seqs.append(ticks[0].numpy())
        caps_seq.append(caps[0])
    seq = np.concatenate(seqs)
    attr = treq.attribute_agent(seq, np.asarray(caps_seq), k_ticks)
    rep = treq.conservation_report(attr, seq[-1],
                                   float(state.lat_sum[0]),
                                   state.hist[0].numpy())
    assert rep["ok"], (seed, rep)


def test_random_workloads_conserve():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=10, deadline=None, derandomize=True)
    @hyp.given(seed=st.integers(0, 2**32 - 1),
               n_intervals=st.integers(1, 6))
    def prop(seed, n_intervals):
        conserve(seed, n_intervals)

    prop()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_deterministic_conservation_slice(seed):
    conserve(seed, n_intervals=4)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
def test_simulate_attribution_and_trace_out(tmp_path, capsys):
    path = tmp_path / "req.json"
    summ = sim_cli.main(["--device", "cpu", "--agents", "3", "--intervals",
                         "10", "--trace-out", str(path), "--attr-sample",
                         "4"])
    out = capsys.readouterr().out
    assert "conservation exact)" in out and "request attribution (" in out
    assert "p99-tail" in out
    assert summ["conservation_ok"].tolist() == [True] * 3
    with open(path) as f:
        trace = json.load(f)
    assert validate_chrome_trace(trace) == []
    n = sum(1 for e in trace["traceEvents"] if e["ph"] == "X")
    assert f"wrote {n} request slices -> {path}" in out
    plain = sim_cli.main(["--device", "cpu", "--agents", "3", "--intervals",
                          "10"])
    for k in ("throughput", "effective_throughput", "p99_latency_s",
              "completed", "dropped"):
        np.testing.assert_array_equal(plain[k], summ[k], err_msg=k)


def test_simulate_without_attribution_prints_none(capsys):
    summ = sim_cli.main(["--device", "cpu", "--agents", "2", "--intervals",
                         "4"])
    assert "request attribution" not in capsys.readouterr().out
    assert "conservation_ok" not in summ
