"""The port's own reference oracles against the JAX package's on the CPU:
the Python discrete-event oracle (``sim/oracle.py``), the single-agent
interval advances (``sim_interval_ref``, ``sim_interval_agent``), the
recompute-oracle Eq. 6 functions and ``buffer_insert`` of
``core/buffer.py``, ``run_episode_reference`` and ``LatencyModel``.

The oracle's request totals and the twin state are exact. Eq. 6 decisions
are exact except that a first divergence is accepted at a near-tie (score
gap below 1e-5 relative; ROADMAP queue 3): the reference solves the
covariance by LU, the streaming engine by Cholesky, and float32 roundoff
can flip a decision there. It is reported, and the agent leaves the
comparison from that step on. Other floats within rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import buffer as jbuf
from repro.core import crl as jcrl
from repro.core import env as jenv
from repro.core import fleet as jfleet
from repro.core.backends import FLUID as J_FLUID
from repro.core.backends import TwinBackend as JTwin
from repro.sim import oracle as joracle
from repro.sim import state as jstate
from repro.sim import step as jstep
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import buffer as tbuf
from repro_torch.core import crl as tcrl
from repro_torch.core import env as tenv
from repro_torch.core import fleet as tfleet
from repro_torch.core.backends import FLUID, TwinBackend
from repro_torch.kernels.diversity import diversity_insert
from repro_torch.kernels.queue_advance import queue_advance
from repro_torch.sim import oracle as toracle
from repro_torch.sim import state as tstate
from repro_torch.sim import step as tstep
from test_torch_support import (NEAR_TIE, close, exact, head_sizes,
                                jax_episode_noise, jax_fleet_tree,
                                near_tie_gap)

SMALL = dict(dt=0.05, k_ticks=8, ring=32, hist_n=16)   # tests/test_sim.py
NA = 15


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def oracle_case(rng, t_ints, k, qcap=8.0, slo=5.0):
    """Arrivals (T, K) and caps (T, 6) with integer-representable
    capacities (the oracle's exactness condition)."""
    arrivals = rng.integers(0, 7, (t_ints, k)).astype(np.int32)
    caps = np.stack([
        rng.choice([1.5, 2.0, 2.5, 3.0], t_ints),
        rng.choice([2.0, 3.0, 4.0], t_ints),
        rng.choice([2.0, 4.0, 8.0], t_ints),
        rng.choice([1.0, 2.0, 3.0], t_ints),
        np.full(t_ints, qcap), np.full(t_ints, slo)], 1).astype(np.float32)
    return arrivals, caps


# ---------------------------------------------------------------------------
# the Python oracle and the single-agent advances
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,qcap", [(0, 8.0), (1, 4.0), (2, 30.0)])
def test_python_oracle_matches_jax_request_for_request(seed, qcap):
    rng = np.random.default_rng(seed)
    tsp = tstate.SimParams(**SMALL)
    arrivals, caps = oracle_case(rng, 15, tsp.k_ticks, qcap)
    want = joracle.simulate_python_agent(arrivals, caps,
                                         jstate.SimParams(**SMALL))
    got = toracle.simulate_python_agent(arrivals, caps, tsp)
    assert got == want
    fleet = toracle.simulate_python_fleet(
        np.stack([arrivals, arrivals[::-1]]), np.stack([caps, caps]), tsp)
    assert fleet[0] == want and len(fleet) == 2


def test_single_agent_advances_match_jax_and_the_oracle():
    """``sim_interval_ref`` and ``sim_interval_agent`` (the plain version
    on the CPU) chained over 15 intervals of one agent: the state equals
    JAX's ``sim_interval_ref`` after every interval, the two port entry
    points equal each other, and the final totals equal the port's Python
    oracle's."""
    rng = np.random.default_rng(3)
    jsp, tsp = jstate.SimParams(**SMALL), tstate.SimParams(**SMALL)
    arrivals, caps = oracle_case(rng, 15, tsp.k_ticks)
    sj = jstate.sim_init(jsp)
    st_ref = tstate.SimState(*(x[0] for x in tstate.sim_init(
        tsp, 1, "cpu").tensors()))
    st_agent = st_ref
    j_step = jax.jit(jstep.sim_interval_ref)
    before = queue_advance.launches
    for t in range(len(arrivals)):
        sj = j_step(sj, jnp.asarray(arrivals[t]), jnp.asarray(caps[t]))
        args = (torch.tensor(arrivals[t]), torch.tensor(caps[t]))
        st_ref = tstep.sim_interval_ref(st_ref, *args)
        st_agent = tstep.sim_interval_agent(st_agent, *args)
        for name, x, y, z in zip(jstate.SimState._fields, st_ref.tensors(),
                                 st_agent.tensors(), sj):
            assert x.shape == np.asarray(z).shape, name
            exact(x, z, f"{name} t={t}")
            assert torch.equal(x, y), name
    assert queue_advance.launches == before      # CPU: plain version
    py = toracle.simulate_python_agent(arrivals, caps, tsp)
    assert (int(st_ref.arrived), int(st_ref.dropped), int(st_ref.completed),
            int(st_ref.effective), float(st_ref.lat_sum),
            int(st_ref.in_flight)) == (
        py["arrived"], py["dropped"], py["completed"], py["effective"],
        py["lat_sum"], py["in_flight"])
    assert py["dropped"] > 0 and py["completed"] > 0


# ---------------------------------------------------------------------------
# Eq. 6: the recompute oracle, buffer_insert, buffer_memory_bytes
# ---------------------------------------------------------------------------
def cands(rng, a, scale=3.0, na=NA):
    s = (rng.normal(size=(a, 8)) * scale).astype(np.float32)
    logits = rng.normal(size=(a, na))
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return s, p.astype(np.float32)


def payload(rng, a):
    return (rng.integers(0, 4, (a, 3)).astype(np.int32),
            *(rng.normal(size=(a,)).astype(np.float32) for _ in range(3)))


def both_buffers(n, a):
    cfg_j, cfg_t = JCfg(buffer_size=n), TCfg(buffer_size=n)
    bj = jax.vmap(lambda _: jbuf.buffer_init(cfg_j))(jnp.arange(a))
    return cfg_j, cfg_t, bj, tbuf.buffer_init(cfg_t, a, "cpu")


def t_cand(s, p, pay):
    act, lp, rw, vl = pay
    return (torch.tensor(s), torch.tensor(act).long(), torch.tensor(lp),
            torch.tensor(rw), torch.tensor(vl), torch.tensor(p))


def decide(score, filled, d):
    """(slot, do) per agent from the buffer before an insert: the first
    empty slot, else the min-score slot iff ``d`` beats it."""
    score, filled, d = (np.asarray(x) for x in (score, filled, d))
    empty = ~filled.all(-1)
    slot = np.where(empty, np.argmin(filled, -1),
                    np.argmin(np.where(filled, score, np.inf), -1))
    low = np.where(filled, score, np.inf).min(-1)
    return slot, empty | (d > low)


def chained_inserts(name, n, a, steps, seed, insert_t, insert_j):
    """``steps`` chained single-candidate inserts on both sides: decisions
    equal (near-tie rule), the agents that did not diverge equal in the
    band after every step. Returns {agent: step of a near-tie}."""
    rng = np.random.default_rng(seed)
    cfg_j, cfg_t, bj, bt = both_buffers(n, a)
    j_div = jax.jit(jax.vmap(lambda b, s, p: jbuf.diversity(cfg_j, b, s, p)))
    ins_j = jax.jit(jax.vmap(lambda b, *xs: insert_j(cfg_j, b, *xs)))
    gone = {}
    for t in range(steps):
        s, p = cands(rng, a)
        pay = payload(rng, a)
        d_t = tbuf.diversity(cfg_t, bt, torch.tensor(s), torch.tensor(p))
        d_j = j_div(bj, s, p)
        slot_t, do_t = decide(bt.score, bt.filled, d_t)
        slot_j, do_j = decide(bj.score, bj.filled, d_j)
        for i in np.flatnonzero((slot_t != slot_j) | (do_t != do_j)):
            if i in gone:
                continue
            gap = near_tie_gap(np.asarray(bj.score)[i], d_t[i], d_j[i],
                               slot_t[i], slot_j[i])
            assert gap <= NEAR_TIE * max(1.0, abs(float(d_j[i]))), \
                f"{name}: agent {i} diverges at step {t}, score gap {gap}"
            print(f"{name}: agent {i} diverges at step {t} at a near-tie "
                  f"(gap {gap:.3g}); accepted")
            gone[int(i)] = t
        bt = insert_t(cfg_t, bt, *t_cand(s, p, pay))
        bj = ins_j(bj, s, pay[0], *pay[1:], p)
        keep = np.array([i not in gone for i in range(a)])
        for f in jbuf.DiversityBuffer._fields:
            x, y = getattr(bt, f)[torch.as_tensor(keep)], \
                np.asarray(getattr(bj, f))[keep]
            if np.issubdtype(y.dtype, np.floating):
                close(x, y, f"{name} {f} step {t}")
            else:
                exact(x, y, f"{name} {f} step {t}")
    return gone


@pytest.mark.parametrize("n,steps", [(8, 30), (16, 40)])
def test_buffer_insert_reference_matches_jax(n, steps):
    """The recompute oracle (LU solve in both packages), chained through
    fill-up into eviction."""
    chained_inserts("reference", n, 6, steps, n, tbuf.buffer_insert_reference,
                    jbuf.buffer_insert_reference)


def test_buffer_insert_matches_jax_streaming_insert():
    """The streaming insert (``buffer_insert_batch`` at T=1: one K1 call
    per step, its plain version here) against JAX's ``buffer_insert``."""
    before = diversity_insert.launches
    chained_inserts("streaming", 8, 6, 30, 7, tbuf.buffer_insert,
                    jbuf.buffer_insert)
    assert diversity_insert.launches == before


def test_streaming_insert_equals_the_recompute_oracle():
    """Within the port: ``buffer_insert`` (Cholesky on the running
    moments) against ``buffer_insert_reference`` (LU on the stored slots),
    decisions under the near-tie rule, stored scores in the band."""
    rng = np.random.default_rng(11)
    cfg = TCfg(buffer_size=8)
    b_s = b_r = tbuf.buffer_init(cfg, 6, "cpu")
    gone = set()
    for t in range(30):
        s, p = cands(rng, 6)
        args = t_cand(s, p, payload(rng, 6))
        d = tbuf.diversity(cfg, b_r, args[0], args[5])
        slot_r, do_r = decide(b_r.score, b_r.filled, d)
        b_s2 = tbuf.buffer_insert(cfg, b_s, *args)
        b_r = tbuf.buffer_insert_reference(cfg, b_r, *args)
        hit_s = (b_s2.score != b_s.score) | (b_s2.filled != b_s.filled)
        for i in range(6):
            if i in gone:
                continue
            slots = torch.nonzero(hit_s[i]).flatten().tolist()
            same = slots == ([int(slot_r[i])] if do_r[i] else [])
            if not same:
                gap = near_tie_gap(b_s.score[i].numpy(), d[i], d[i],
                                   int(slot_r[i]), slots[0] if slots
                                   else int(slot_r[i]))
                assert gap <= NEAR_TIE * max(1.0, abs(float(d[i]))), \
                    f"agent {i} step {t}: no near-tie ({gap})"
                gone.add(i)
        b_s = b_s2
        keep = torch.tensor([i not in gone for i in range(6)])
        close(b_s.score[keep], b_r.score[keep].numpy(), f"score step {t}")
        exact(b_s.filled[keep], b_r.filled[keep].numpy())
        close(b_s.s_outer[keep], b_r.s_outer[keep].numpy())
    assert len(gone) < 6


def test_recompute_functions_match_jax():
    """``mahalanobis``, ``kl_divergence`` and ``diversity`` on buffers
    empty, partly filled and full."""
    rng = np.random.default_rng(5)
    a, n = 5, 12
    states = (rng.normal(size=(a, n, 8)) * 2).astype(np.float32)
    filled = np.zeros((a, n), bool)
    for i, k in enumerate((0, 1, 4, 9, 12)):
        filled[i, :k] = True
    state = rng.normal(size=(a, 8)).astype(np.float32)
    close(tbuf.mahalanobis(*(torch.tensor(x) for x in (state, states,
                                                       filled))),
          jax.vmap(jbuf.mahalanobis)(state, states, filled), "D_M")
    p = rng.dirichlet(np.ones(NA), size=a).astype(np.float32)
    q = rng.dirichlet(np.ones(NA), size=a).astype(np.float32)
    q[0, 3] = 0.0
    close(tbuf.kl_divergence(torch.tensor(p), torch.tensor(q)),
          jbuf.kl_divergence(p, q), "KL")
    cfg_j, cfg_t, bj, bt = both_buffers(n, a)
    probs = rng.dirichlet(np.ones(NA), size=(a, n)).astype(np.float32)
    bj = bj._replace(states=jnp.asarray(states), probs=jnp.asarray(probs),
                     filled=jnp.asarray(filled))
    bt = bt.replace(states=torch.tensor(states), probs=torch.tensor(probs),
                    filled=torch.tensor(filled))
    close(tbuf.diversity(cfg_t, bt, torch.tensor(state), torch.tensor(p)),
          jax.vmap(lambda b, s, pp: jbuf.diversity(cfg_j, b, s, pp))(
              bj, state, p), "Eq. 6")


@pytest.mark.parametrize("n,n_mt", [(64, 4), (700, 2)])
def test_buffer_memory_bytes(n, n_mt):
    """The port's bytes per agent are the reference's plus the int64
    ``actions`` (12 bytes a slot more than int32; ROADMAP queue 3)."""
    want = jbuf.buffer_memory_bytes(JCfg(buffer_size=n, n_mt=n_mt))
    got = tbuf.buffer_memory_bytes(TCfg(buffer_size=n, n_mt=n_mt))
    assert got == want + 12 * n
    b = tbuf.buffer_init(TCfg(buffer_size=n, n_mt=n_mt), 3, "cpu")
    assert 3 * got == sum(getattr(b, f).numel() * getattr(b, f)
                          .element_size() for f in jbuf.DiversityBuffer
                          ._fields)


# ---------------------------------------------------------------------------
# run_episode_reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["fluid", "twin"])
def test_run_episode_reference_matches_jax(backend):
    """The seed episode loop (one recompute-oracle insert per step) over
    two chained episodes of A=4 agents on JAX's replayed noise: rollouts
    (actions exact), metrics, the final buffers and env state; and its
    rollouts equal ``run_episode``'s bit for bit (the buffer never feeds
    back into an episode)."""
    cfg_j, cfg_t = JCfg(buffer_size=8), TCfg(buffer_size=8)
    jb, tb = {"fluid": (J_FLUID, FLUID),
              "twin": (JTwin(sp=jstate.SimParams()),
                       TwinBackend(sp=tstate.SimParams()))}[backend]
    a = 4
    jf = jfleet.fleet_init(cfg_j, a, jax.random.PRNGKey(2), env_backend=jb)
    tf = tfleet.fleet_from_numpy(cfg_t, jax_fleet_tree(jf), device="cpu")
    run_j = jax.jit(jax.vmap(lambda ep, st, r, m: jcrl.run_episode_reference(
        cfg_j, ep, st, r, m, backend=jb)))
    js, ts, rngs = jf.astate, tf.astate, jf.astate.rng
    rng = np.random.default_rng(1)
    for e in range(2):
        rates = rng.uniform(5.0, 160.0, (a, 10)).astype(np.float32)
        g, rngs = jax_episode_noise(rngs, 10, head_sizes(cfg_j))
        js, roll_j, met_j = run_j(jf.env_params, js, jnp.asarray(rates),
                                  jf.masks)
        ts2, roll_t, met_t = tcrl.run_episode_reference(
            cfg_t, tf.env_params, ts, torch.tensor(rates), tf.masks,
            backend=tb, gumbel=torch.tensor(np.asarray(g)))
        _, roll_s, met_s = tcrl.run_episode(
            cfg_t, tf.env_params, ts, torch.tensor(rates), tf.masks,
            backend=tb, gumbel=torch.tensor(np.asarray(g)))
        ts = ts2
        exact(roll_t.actions, roll_j.actions, f"actions episode {e}")
        for f in ("states", "logp_old", "rewards", "values_old"):
            close(getattr(roll_t, f), getattr(roll_j, f), f)
            assert torch.equal(getattr(roll_t, f), getattr(roll_s, f)), f
        assert set(met_t) == set(met_j)
        for k, v in met_t.items():
            close(v, met_j[k], k)
            assert torch.equal(v, met_s[k]), k
        for f in jbuf.DiversityBuffer._fields:
            y = np.asarray(getattr(js.buffer, f))
            x = getattr(ts.buffer, f)
            if np.issubdtype(y.dtype, np.floating):
                close(x, y, f"buffer.{f} episode {e}")
            else:
                exact(x, y, f"buffer.{f} episode {e}")
    assert bool(ts.buffer.filled.all())       # the second episode evicts
    if backend == "twin":
        for f in jstate.SimState._fields:
            exact(getattr(ts.env_state.sim, f),
                  getattr(js.env_state.sim, f), f)


# ---------------------------------------------------------------------------
# LatencyModel
# ---------------------------------------------------------------------------
def test_latency_model():
    """The same arguments give the same (t0, t1) in both packages; the
    port's defaults are the H100's data-sheet rates (bf16 dense, HBM3) and
    its measured decode-step overhead, not the TPU's of the reference."""
    args = (2.0e9, 1.0e9)
    kw = dict(peak_flops=197e12, hbm_bw=819e9, overhead_s=2e-3)
    want = jenv.LatencyModel.from_roofline(*args, **kw)
    got = tenv.LatencyModel.from_roofline(*args, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    t0, t1 = tenv.LatencyModel.from_roofline(*args)
    assert t1 == args[0] / 989e12
    assert t0 == args[1] / 3.35e12 + tenv.DECODE_OVERHEAD_S
    assert (t0, t1) != tuple(want)
    assert 0 < tenv.DECODE_OVERHEAD_S < 0.1
