"""The port's request-level twin (``repro_torch.sim`` and K3's plain
version) against the JAX package on the CPU.

Same numpy inputs into ``repro.sim`` / ``repro.kernels`` and their
counterparts in the port. The twin's integer state is compared exactly, and
so are its float32 credits and latency sums (every operation that feeds
them is reproduced in the reference's order); caps and arrival spreading
bit for bit against the compiled (``jit``) JAX functions; other floats
within rtol 1e-4 / atol 1e-5.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import env as jenv
from repro.core.backends import TwinBackend as JTwin
from repro.core.fleet import fleet_init as j_fleet_init
from repro.kernels import ref as jref
from repro.kernels.queue_advance import queue_advance as j_pallas_qa
from repro.sim import harness as jharness
from repro.sim import metrics as jmetrics
from repro.sim import state as jstate
from repro.sim.oracle import simulate_python_agent as j_simulate_python_agent
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import env as tenv
from repro_torch.core.agent import ActionMask, tensors_from_numpy
from repro_torch.core.backends import TwinBackend, TwinEnvState
from repro_torch.kernels import ref as tref
from repro_torch.kernels.queue_advance import queue_advance
from repro_torch.sim import harness as tharness
from repro_torch.sim import metrics as tmetrics
from repro_torch.sim.oracle import simulate_python_agent
from repro_torch.sim import state as tstate
from test_torch_support import (close, env_state_tree, exact, head_sizes,
                                jax_sim_noise, np_tree)

SMALL = dict(dt=0.05, k_ticks=8, ring=32, hist_n=16)   # tests/test_sim.py
CFG_J, CFG_T = JCfg(), TCfg()
SIM_FIELDS = ("arrive", "counters", "credits", "lat_sum", "hist")


def both_sp(**kw):
    return jstate.SimParams(**kw), tstate.SimParams(**kw)


def empty_state(a, sp):
    return [np.zeros((a, sp.ring), np.int32),
            np.zeros((a, tref.SIM_NCOUNTERS), np.int32),
            np.zeros((a, 2), np.float32), np.zeros((a,), np.float32),
            np.zeros((a, sp.hist_n), np.int32)]


def small_args(rng, a, sp):
    """tests/test_sim.py's random intervals: 0-6 arrivals per tick, caps
    around [2.5, 3, 4, 2, 8, 5] with integer-step jitter."""
    arrivals = rng.integers(0, 7, (a, sp.k_ticks)).astype(np.int32)
    jitter = rng.integers(0, 3, (a, 6)).astype(np.float32)
    caps = (np.asarray([2.5, 3.0, 4.0, 2.0, 8.0, 5.0], np.float32)[None]
            + jitter * np.asarray([0.5, 0.5, 1.0, 1.0, 0.0, 0.0], np.float32))
    return arrivals, caps.astype(np.float32)


def overload_args(rng, a, sp):
    """3-6x the arrivals the caps serve (post service is the bottleneck),
    with the smallest batch and small queues: the post queue fills to its
    room bound, then backpressure reaches admission and requests drop."""
    c_post = rng.uniform(0.2, 0.5, a).astype(np.float32)
    caps = np.stack([rng.uniform(1.0, 2.0, a), c_post, np.ones(a),
                     np.ones(a), np.full(a, 8.0),
                     np.full(a, 5.0)], 1).astype(np.float32)
    mult = rng.uniform(3.0, 6.0, (a, 1))
    arrivals = rng.poisson(mult * c_post[:, None], (a, sp.k_ticks))
    return arrivals.astype(np.int32), caps


def run_jax(kind, state, arrivals, caps):
    args = [jnp.asarray(x) for x in (*state, arrivals, caps)]
    if kind == "pallas":
        return j_pallas_qa(*args, interpret=True)
    return jax.vmap(jref.queue_advance_ref)(*args)


def assert_sim_equal(got, want, msg=""):
    for name, g, w in zip(SIM_FIELDS, got, want):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{name} {msg}")


# ---------------------------------------------------------------------------
# K3's plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["oracle", pytest.param(
    "pallas", marks=pytest.mark.pallas)])
def test_queue_advance_plain_matches_jax_chained(kind):
    """Five chained intervals at the small geometry, bit for bit against
    ``vmap(ref.queue_advance_ref)`` and the Pallas kernel (interpret)."""
    sp = tstate.SimParams(**SMALL)
    rng = np.random.default_rng(0)
    state = empty_state(4, sp)
    for i in range(5):
        arrivals, caps = small_args(rng, 4, sp)
        want = run_jax(kind, state, arrivals, caps)
        got = queue_advance(*(torch.tensor(x) for x in state),
                            torch.tensor(arrivals), torch.tensor(caps))
        assert_sim_equal(got, want, f"interval {i}")
        state = [np.asarray(x) for x in want]
    counters = state[1]
    assert counters[:, tref.SIM_COMPLETED].sum() > 0
    assert counters[:, tref.SIM_DROPPED].sum() > 0


@pytest.mark.parametrize("kind", ["oracle", pytest.param(
    "pallas", marks=pytest.mark.pallas)])
def test_queue_advance_plain_matches_jax_overloaded_default_geometry(kind):
    """SimParams() (R=512, H=64, K=20), A=4, overload: drops, a full post
    queue, conservation; bit for bit over three chained intervals."""
    sp = tstate.SimParams()
    rng = np.random.default_rng(1)
    state = empty_state(4, sp)
    for i in range(3):
        arrivals, caps = overload_args(rng, 4, sp)
        want = run_jax(kind, state, arrivals, caps)
        got = queue_advance(*(torch.tensor(x) for x in state),
                            torch.tensor(arrivals), torch.tensor(caps))
        assert_sim_equal(got, want, f"interval {i}")
        state = [np.asarray(x) for x in want]
    st = tstate.SimState(*(torch.tensor(x) for x in state))
    c = st.counters
    assert (st.dropped > 0).all()
    # post queue + the batch in service at the room bound (qcap)
    exact(c[:, tref.SIM_LAUNCH] - c[:, tref.SIM_HEAD],
          caps[:, tref.CAP_QCAP].astype(np.int32))
    exact(st.arrived, st.dropped + st.completed + st.in_flight)


def k3_two_phases(arrive, counters, credits, lat_sum, hist, arrivals, caps):
    """A numpy emulation of ``csrc/queue_advance.cu``'s decomposition, per
    agent: phase 1 runs the scalar chain of all K ticks and keeps the
    schedule (head and tail before each tick); phase 2 takes each request
    completed in the interval, finds its completion tick and its arrival
    (the input ring if it was in flight at the start, else the microtick of
    the tick that admitted it), and adds its latency to a per-tick integer
    sum, the effective count and the histogram; lat_sum folds the per-tick
    sums in tick order; the last R requests admitted (the last writer of
    each slot they map onto) write their admission tick into the ring, and
    every other slot keeps its input value."""
    out = [x.copy() for x in (arrive, counters, credits, lat_sum, hist)]
    n_agents, ring = arrive.shape
    k, hist_n = arrivals.shape[1], hist.shape[1]
    f32, one = np.float32, np.float32(1.0)

    def tick_of(sched, j):       # the last tick whose segment holds j
        return sum(sched[u] - sched[0] <= j for u in range(1, k))

    for i in range(n_agents):
        c = [int(v) for v in counters[i]]
        cr_pre, cr_post = credits[i]
        c_pre, c_post = caps[i, tref.CAP_PRE], caps[i, tref.CAP_POST]
        batch, t_batch, qcap, slo = (int(caps[i, j]) for j in (
            tref.CAP_BATCH, tref.CAP_TBATCH, tref.CAP_QCAP, tref.CAP_SLO))
        s_head, s_tail = [], []
        for t in range(k):                                  # phase 1
            n_arr, m = int(arrivals[i, t]), c[tref.SIM_TICK]
            s_head.append(c[tref.SIM_HEAD])
            s_tail.append(c[tref.SIM_TAIL])
            done = c[tref.SIM_BUSY] > 0 and m >= c[tref.SIM_DONE_AT]
            p_inf = c[tref.SIM_LAUNCH] if done else c[tref.SIM_PINF]
            busy = 0 if done else c[tref.SIM_BUSY]
            post = np.minimum(cr_post + c_post, c_post + one)
            n_post = min(int(post), p_inf - c[tref.SIM_HEAD])
            post = post - f32(n_post)
            head = c[tref.SIM_HEAD] + n_post
            ready = c[tref.SIM_PPRE] - c[tref.SIM_LAUNCH]
            room = qcap - (c[tref.SIM_LAUNCH] - head)
            n_launch = max(min(ready, batch, room), 0)
            do_launch = busy == 0 and n_launch > 0
            launch = c[tref.SIM_LAUNCH] + (n_launch if do_launch else 0)
            done_at = m + t_batch if do_launch else c[tref.SIM_DONE_AT]
            busy = 1 if do_launch else busy
            pre = np.minimum(cr_pre + c_pre, c_pre + one)
            n_pre = max(min(int(pre), c[tref.SIM_TAIL] - c[tref.SIM_PPRE],
                            max(qcap - (c[tref.SIM_PPRE] - launch), 0)), 0)
            pre = pre - f32(n_pre)
            p_pre = c[tref.SIM_PPRE] + n_pre
            free = min(qcap - (c[tref.SIM_TAIL] - p_pre),
                       ring - (c[tref.SIM_TAIL] - head))
            admit = min(max(min(n_arr, free), 0), n_arr)
            c[tref.SIM_TAIL] += admit
            c[tref.SIM_PPRE], c[tref.SIM_LAUNCH], c[tref.SIM_PINF] = \
                p_pre, launch, p_inf
            c[tref.SIM_HEAD], c[tref.SIM_BUSY], c[tref.SIM_DONE_AT] = \
                head, busy, done_at
            c[tref.SIM_ARRIVED] += n_arr
            c[tref.SIM_DROPPED] += n_arr - admit
            c[tref.SIM_COMPLETED] += n_post
            c[tref.SIM_TICK] = m + 1
            cr_pre, cr_post = pre, post
        s_head.append(c[tref.SIM_HEAD])
        s_tail.append(c[tref.SIM_TAIL])
        head0, tail0 = s_head[0], s_tail[0]
        tick0 = int(counters[i, tref.SIM_TICK])
        lsum, neff = [0] * k, 0
        for j in range(s_head[k] - head0):                  # phase 2
            t = tick_of(s_head, j)
            arrival = (arrive[i, (head0 + j) % ring] if j < tail0 - head0
                       else tick0 + tick_of(s_tail, j - (tail0 - head0)))
            lat = tick0 + t + 1 - int(arrival)
            lsum[t] += lat
            neff += lat <= slo
            out[4][i, min(max(lat, 0), hist_n - 1)] += 1
        ls = lat_sum[i]
        for t in range(k):
            ls = ls + f32(lsum[t])
        out[3][i] = ls
        c[tref.SIM_EFFECTIVE] += neff
        out[1][i], out[2][i] = c, (cr_pre, cr_post)
        n_adm = s_tail[k] - tail0
        for j in range(max(n_adm - ring, 0), n_adm):        # last writers
            out[0][i, (tail0 + j) % ring] = tick0 + tick_of(s_tail, j)
    return out


def wrap_args(rng, a, sp):
    """A ring of 8 under heavy load: service outruns 3-5 arrivals a tick,
    so far more than R requests are admitted in one interval and most of
    them also complete in it."""
    caps = np.tile(np.asarray([4.0, 4.0, 4.0, 1.0, 4.0, 3.0], np.float32),
                   (a, 1))
    caps[:, tref.CAP_POST] = rng.uniform(3.5, 5.0, a)
    arrivals = rng.integers(3, 6, (a, sp.k_ticks)).astype(np.int32)
    return arrivals, caps


# (ring, hist_n, k_ticks, intervals, arrivals and caps): the small geometry,
# the default geometry in overload, a ring of 8 wrapping several times an
# interval, one tick an interval, one histogram bucket
K3_CASES = {
    "small": (32, 16, 8, 5, small_args),
    "default_overload": (512, 64, 20, 3, overload_args),
    "ring8_wrap": (8, 16, 20, 4, wrap_args),
    "k1": (32, 16, 1, 12, small_args),
    "h1": (32, 1, 8, 5, small_args),
}


@pytest.mark.parametrize("kind", ["oracle", pytest.param(
    "pallas", marks=pytest.mark.pallas)])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_two_phase_decomposition_matches_jax(case, kind):
    """The kernel's decomposition (``k3_two_phases``), the port's plain
    version and JAX (``vmap(ref.queue_advance_ref)`` or the Pallas kernel
    in interpret mode) agree bit for bit over chained intervals."""
    ring, hist_n, k, n_int, draw = K3_CASES[case]
    sp = tstate.SimParams(ring=ring, k_ticks=k, hist_n=max(hist_n, 2))
    rng = np.random.default_rng(len(case))
    a = 4
    state = empty_state(a, sp)
    state[4] = np.zeros((a, hist_n), np.int32)
    wrapped = False
    for i in range(n_int):
        arrivals, caps = draw(rng, a, sp)
        want = run_jax(kind, state, arrivals, caps)
        assert_sim_equal(k3_two_phases(*state, arrivals, caps), want,
                         f"{case} two phases, interval {i}")
        got = queue_advance(*(torch.tensor(x) for x in state),
                            torch.tensor(arrivals), torch.tensor(caps))
        assert_sim_equal(got, want, f"{case} plain, interval {i}")
        new = [np.asarray(x) for x in want]
        admitted = new[1][:, tref.SIM_TAIL] - state[1][:, tref.SIM_TAIL]
        done = new[1][:, tref.SIM_HEAD] - state[1][:, tref.SIM_HEAD]
        in_flight = state[1][:, tref.SIM_TAIL] - state[1][:, tref.SIM_HEAD]
        wrapped |= bool(((admitted > ring) & (done > in_flight)).any())
        state = new
    assert state[1][:, tref.SIM_COMPLETED].sum() > 0
    assert wrapped or case != "ring8_wrap"


def test_k3_stamps_anchor_in_todays_source():
    """K3's phase marks are empty in ``csrc/queue_advance.cu`` as built (no
    timing code), every phase that ``chip_smoke.py`` reads is marked in
    today's source, and its timing build defines the marks as clock64
    stamps before it includes that source."""
    import importlib.util
    import re
    from pathlib import Path
    from repro_torch.kernels import build
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    source = build.CSRC / "queue_advance.cu"
    src = source.read_text()
    assert "clock64" not in re.sub(r"//.*", "", src)
    guard = src[src.index("#ifndef K3_PHASE_MARKS"):]
    guard = guard[:guard.index("#endif")]
    for mark in ("K3_MARK_START()", "K3_MARK(phase)", "K3_MARK_END()"):
        assert f"#define {mark}\n" in guard
    marks = set(re.findall(r"^ *K3_MARK\((\w+)\);$", src, re.M))
    assert marks == {mark for mark, _ in smoke.K3_PHASES}
    assert src.count("K3_MARK_START();") == 1
    unit = smoke.stamped_source("K3", smoke.K3_PHASES, source,
                                smoke.K3_WARPS)
    assert (unit.index("#define K3_PHASE_MARKS")
            < unit.index("#define K3_MARK(phase) k3_stamp(K3_PH_##phase)")
            < unit.index(f'#include "{source}"'))


def test_queue_advance_plain_keeps_its_inputs_and_checks_the_ring():
    sp = tstate.SimParams(**SMALL)
    state = [torch.tensor(x) for x in empty_state(2, sp)]
    arrivals, caps = small_args(np.random.default_rng(2), 2, sp)
    before = [x.clone() for x in state]
    queue_advance(*state, torch.tensor(arrivals), torch.tensor(caps))
    assert all(torch.equal(a, b) for a, b in zip(state, before))
    bad = [torch.zeros(2, 24, dtype=torch.int32)] + state[1:]
    with pytest.raises(ValueError, match="power of two"):
        queue_advance(*bad, torch.tensor(arrivals), torch.tensor(caps))


def oracle_inputs(tsp, t_ints=12):
    """One agent's arrivals (T, K) and caps (T, SIM_NCAPS) for the Python
    oracle, with integer-representable capacities."""
    rng = np.random.default_rng(0)
    arrivals = rng.integers(0, 7, (t_ints, tsp.k_ticks)).astype(np.int32)
    caps = np.stack([
        rng.choice([1.5, 2.0, 2.5, 3.0], t_ints),
        rng.choice([2.0, 3.0, 4.0], t_ints),
        rng.choice([2.0, 4.0, 8.0], t_ints),
        rng.choice([1.0, 2.0, 3.0], t_ints),
        np.full(t_ints, 8.0),
        np.full(t_ints, 5.0)], axis=1).astype(np.float32)
    return arrivals, caps


def twin_against_oracle(tsp, arrivals, caps, py):
    s = tstate.sim_init(tsp, 1, "cpu")
    for t in range(len(arrivals)):
        s = tstate.SimState(*queue_advance(
            *s.tensors(), torch.tensor(arrivals[t:t + 1]),
            torch.tensor(caps[t:t + 1])))
    assert int(s.arrived[0]) == py["arrived"]
    assert int(s.dropped[0]) == py["dropped"]
    assert int(s.completed[0]) == py["completed"]
    assert int(s.effective[0]) == py["effective"]
    assert float(s.lat_sum[0]) == py["lat_sum"]
    assert int(s.in_flight[0]) == py["in_flight"]
    assert py["dropped"] > 0 and py["completed"] > 0


def test_twin_matches_python_oracle_request_for_request():
    """The port's twin == the port's ``sim/oracle.py`` (``serving/slo.py``'s
    data plane) on one agent: completions, drops, effective count, summed
    latency and requests in flight (integer caps entries => exact)."""
    tsp = tstate.SimParams(**SMALL)
    arrivals, caps = oracle_inputs(tsp)
    twin_against_oracle(tsp, arrivals, caps,
                        simulate_python_agent(arrivals, caps, tsp))


def test_twin_matches_the_jax_python_oracle_request_for_request():
    """The same against the JAX package's ``repro.sim.oracle``."""
    jsp, tsp = both_sp(**SMALL)
    arrivals, caps = oracle_inputs(tsp)
    twin_against_oracle(tsp, arrivals, caps,
                        j_simulate_python_agent(arrivals, caps, jsp))


# ---------------------------------------------------------------------------
# action decode and arrival spreading
# ---------------------------------------------------------------------------
def env_params_pair(speeds):
    jep = jax.vmap(lambda s: jenv.default_env_params(s, 0.25))(
        jnp.asarray(speeds, jnp.float32))
    tep = tenv.EnvParams(**{k: torch.tensor(np.asarray(v))
                            for k, v in jep._asdict().items()})
    return jep, tep


@pytest.mark.parametrize("geometry", [SMALL, {}, dict(dt=0.03, k_ticks=7)])
def test_action_caps_match_compiled_jax_for_every_action(geometry):
    """Every (res, bs, mt) action on the default device mix and 40 random
    device speeds: the caps equal the compiled JAX decode bit for bit (the
    port reproduces XLA's two fused multiply-adds and its ``1/dt``
    products; PERF.md)."""
    jsp, tsp = both_sp(**geometry)
    acts = np.array(list(itertools.product(range(4), range(7), range(4))),
                    np.int32)
    speeds = np.concatenate([[0.5, 0.75, 1.0, 2.0],
                             np.random.default_rng(5).uniform(0.25, 3, 40)])
    act = np.repeat(acts, len(speeds), 0)
    jep, tep = env_params_pair(np.tile(speeds, len(acts)))
    want = np.asarray(jax.jit(jax.vmap(
        lambda e, a: jstate.action_caps(CFG_J, jsp, e, a)))(
        jep, jnp.asarray(act)))
    got = tstate.action_caps(CFG_T, tsp, tep, torch.tensor(act).long())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("geometry", [SMALL, {}, dict(dt=0.03, k_ticks=7)])
def test_spread_arrivals_match_compiled_jax_with_phase_carry(geometry):
    """A sweep of 512 rates (edge values included) chained over 25
    intervals: counts and the float32 phase carry bit for bit."""
    jsp, tsp = both_sp(**geometry)
    rng = np.random.default_rng(3)
    spread = jax.jit(jax.vmap(lambda r, p: jstate.spread_arrivals(jsp, r, p)))
    ph_j, ph_t = jnp.zeros(512, jnp.float32), torch.zeros(512)
    for _ in range(25):
        rate = rng.uniform(0.0, 400.0, 512).astype(np.float32)
        rate[:8] = [0.0, 1.0, 17.3, 30.9, 399.9, 20.0, 0.5, 123.456]
        cnt_j, ph_j = spread(jnp.asarray(rate), ph_j)
        cnt_t, ph_t = tstate.spread_arrivals(tsp, torch.tensor(rate), ph_t)
        assert cnt_t.dtype == torch.int32
        exact(cnt_t, cnt_j)
        np.testing.assert_array_equal(ph_t.numpy().view(np.int32),
                                      np.asarray(ph_j).view(np.int32))
        assert ((ph_t >= 0) & (ph_t < 1)).all()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def test_hist_percentile_and_summarize_match_jax():
    rng = np.random.default_rng(4)
    a, h = 6, 16
    hist = rng.integers(0, 30, (a, h)).astype(np.int32)
    hist[0] = 0                                  # empty histogram
    hist[1, -1] = 500                            # right-censored agent
    for q in (0.0, 0.5, 0.99, 1.0):
        exact(tmetrics.hist_percentile(torch.tensor(hist), q),
              jmetrics.hist_percentile(jnp.asarray(hist), q))
    counters = rng.integers(0, 1000, (a, tref.SIM_NCOUNTERS)).astype(np.int32)
    counters[2] = 0                              # nothing simulated yet
    state = [np.zeros((a, 32), np.int32), counters,
             rng.uniform(0, 2, (a, 2)).astype(np.float32),
             rng.uniform(0, 5e3, a).astype(np.float32), hist]
    jsp, tsp = both_sp(**SMALL)
    want = jmetrics.summarize(jstate.SimState(*map(jnp.asarray, state)), jsp)
    got = tmetrics.summarize(tstate.SimState(*map(torch.tensor, state)), tsp)
    assert set(got) == set(want)
    for k, v in want.items():
        close(got[k], v, k)
    with pytest.warns(UserWarning, match="right-censored"):
        frac = tmetrics.warn_if_censored(got, tsp)
    assert frac == pytest.approx(float(np.max(want["hist_censored"])))


# ---------------------------------------------------------------------------
# the twin backend, one step
# ---------------------------------------------------------------------------
def test_twin_backend_observe_and_step_match_jax():
    """From the same mid-run state (JAX drives four intervals at 80 req/s
    with random actions), one observe + step: the observation, reward,
    info and the new state."""
    jsp, tsp = both_sp(**SMALL)
    a = 5
    jbe, tbe = JTwin(sp=jsp), TwinBackend(sp=tsp)
    speeds = np.asarray([0.5, 0.75, 1.0, 2.0, 1.0], np.float32)
    jep, tep = env_params_pair(speeds)
    step = jax.jit(jax.vmap(lambda e, s, ac, r: jbe.step(CFG_J, e, s, ac, r)))
    observe = jax.jit(jax.vmap(lambda e, s, r: jbe.observe(CFG_J, e, s, r)))
    js = jax.vmap(lambda _: jbe.init(CFG_J))(jnp.arange(a))
    rng = np.random.default_rng(6)
    draw = lambda: np.stack([rng.integers(0, 4, a), rng.integers(0, 7, a),
                             rng.integers(0, 4, a)], 1).astype(np.int32)
    for _ in range(4):
        js, _, _ = step(jep, js, jnp.asarray(draw()), jnp.full(a, 80.0))
    tree = env_state_tree(js)
    ts = TwinEnvState(
        sim=tstate.SimState(*(torch.tensor(tree["sim"][f])
                              for f in SIM_FIELDS)),
        cur_action=torch.tensor(tree["cur_action"]).long(),
        drops_prev=torch.tensor(tree["drops_prev"]),
        phase=torch.tensor(tree["phase"]), ema_lat=torch.tensor(tree["ema_lat"]))
    rate = rng.uniform(20, 150, a).astype(np.float32)
    close(tbe.observe(CFG_T, tep, ts, torch.tensor(rate)),
          observe(jep, js, jnp.asarray(rate)), "obs")
    action = draw()
    js2, jr, jinfo = step(jep, js, jnp.asarray(action), jnp.asarray(rate))
    ts2, tr, tinfo = tbe.step(CFG_T, tep, ts, torch.tensor(action).long(),
                              torch.tensor(rate))
    close(tr, jr, "reward")
    for k, v in jinfo.items():
        close(tinfo[k], v, k)
    want = env_state_tree(js2)
    assert_sim_equal(ts2.sim.tensors(), [want["sim"][f] for f in SIM_FIELDS])
    for k in ("cur_action", "drops_prev", "phase"):
        exact(getattr(ts2, k), want[k], k)
    close(ts2.ema_lat, want["ema_lat"], "ema_lat")
    close(ts2.pre_q, js2.pre_q, "pre_q")
    assert int(ts2.sim.completed.sum()) > 0


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------
def test_simulate_fleet_matches_jax():
    """A=3, 6 intervals, the small geometry with ring 64 (queue_cap clamps
    to 21 and both packages warn): the port, replaying JAX's Gumbel noise,
    reproduces JAX's actions, so the final state is identical and the
    per-interval history and summary agree within the band."""
    jsp, tsp = both_sp(**dict(SMALL, ring=64))
    a, n_int = 3, 6
    jf = j_fleet_init(CFG_J, a, jax.random.PRNGKey(0))
    traces = np.random.default_rng(7).uniform(5.0, 200.0, (a, n_int)).astype(
        np.float32)
    key = jax.random.PRNGKey(2)
    with pytest.warns(UserWarning, match="clamps queue_cap"):
        js, jhist, jsumm = jharness.simulate_fleet(
            CFG_J, jsp, jf.astate.params, jf.masks, jf.env_params,
            jnp.asarray(traces), key)
    gumbel = torch.tensor(np.asarray(
        jax_sim_noise(key, n_int, a, head_sizes(CFG_J))))
    masks = ActionMask(*(torch.tensor(np.asarray(getattr(jf.masks, k)))
                         for k in ("res", "bs", "mt")))
    tep = tenv.EnvParams(**{k: torch.tensor(np.asarray(v))
                            for k, v in jf.env_params._asdict().items()})
    with pytest.warns(UserWarning, match="clamps queue_cap"):
        ts, thist, tsumm = tharness.simulate_fleet(
            CFG_T, tsp, tensors_from_numpy(np_tree(jf.astate.params), "cpu"),
            masks, tep, torch.tensor(traces), gumbel=gumbel)
    assert_sim_equal(ts.tensors(), js)
    assert set(thist) <= set(jhist)
    for k, v in thist.items():
        assert v.shape == (n_int, a), k
        close(v, jhist[k], k)
    for k, v in jsumm.items():
        close(tsumm[k], v, k)
    assert int(ts.completed.sum()) > 0 and int(ts.dropped.sum()) > 0
