"""The health observatory of the PyTorch port (``repro_torch.health``, its
wiring into both fleet drivers and the suspicion gate) against the JAX
package's, on the CPU.

Module parity: the same numpy inputs from a seed through JAX's jitted
functions and the port's. Histogram counts, bin indices, marker
positions, drift flags and gate decisions exact; floats within rtol 1e-4
/ atol 1e-5 (a drift alarm whose statistic lies within float32 roundoff
of 1.0 is accepted and reported, as K1's near-ties are).

Driver parity: A=8, P=2, ``fl_every=1``, eight episodes, int8 with a
deadline, byzantine sign_flip 0.25, stragglers 0.25, JAX's Gumbel noise
replayed, fluid and twin, under both of the port's drivers (bit for bit
with each other). Against JAX: histories within the band and actions,
per-round selections, histogram counts and drift flags exact. The
suspicion (``health_susp``, the state's ``susp``) is held within rtol
1e-3 / atol 1e-4: attribution reads ``params - base`` and the int8 wire
deltas, where the parameters' float32 band is amplified by the
cancellation (a delta is ~1e-2 of its parameters) and by int8 rounding
ties (``close_decoded``'s rule); on identical inputs the scores agree
within the band (``test_attribution_matches_jax``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import federated as jfed
from repro.core import fleet as jfleet
from repro.core.backends import TwinBackend as JTwin
from repro.fl import transport as jtr
from repro import health as jh
from repro.health import attribution as jattr
from repro.health import drift as jdrift
from repro.health import sketch as jsk
from repro.resilience import faults as jfaults
from repro.resilience import guards as jguards
from repro.sim.state import SimParams as JSimParams
from repro_torch import health as th
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import federated as tfed
from repro_torch.core import fleet as tfleet
from repro_torch.core.backends import TwinBackend
from repro_torch.fl import transport as ttr
from repro_torch.health import attribution as tattr
from repro_torch.health import drift as tdrift
from repro_torch.health import sketch as tsk
from repro_torch.resilience import faults as tfaults
from repro_torch.resilience import guards as tguards
from repro_torch.sim.state import SimParams
from torch.utils._python_dispatch import TorchDispatchMode
from test_torch_support import (close, exact, head_sizes, jax_episode_noise,
                                jax_fleet_tree)

T = torch.tensor
J = jnp.asarray
DK = dict(k=0.5, h=10.0, ph_delta=0.2, ph_lambda=25.0, ema_slow=0.02,
          ema_fast=0.3, warmup=5, zclip=8.0, var_floor=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_fields(x):
    """A JAX NamedTuple state (nested) as nested numpy dicts."""
    return {k: np_fields(v) if hasattr(v, "_asdict") else np.asarray(v)
            for k, v in x._asdict().items()}


def t_fields(x):
    """A port dataclass state (nested) as nested numpy dicts."""
    return {k: t_fields(v) if dataclasses.is_dataclass(v)
            else v.detach().numpy() for k, v in vars(x).items()}


# ---------------------------------------------------------------------------
# Sketches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bins", [16, 10, 7])
@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (0.0, 1.0)])
def test_histogram_matches_jax(bins, lo, hi):
    """Bin counts exact (out-of-range values, exact bin edges and their
    float32 neighbours included) at a power-of-two bin count and at two
    that are not; quantiles within the band, as JAX's jitted program
    computes them (reciprocal products, fused multiply-add)."""
    rng = np.random.default_rng(bins)
    edges = np.linspace(lo, hi, bins + 1).astype(np.float32)
    xs = np.concatenate([
        rng.uniform(lo - 0.2, hi + 0.2, (6, 400)).astype(np.float32),
        np.tile(np.concatenate([edges, np.nextafter(edges, np.inf),
                                np.nextafter(edges, -np.inf)]), (6, 1))], 1)
    upd = jax.jit(jax.vmap(lambda c, x: jsk.hist_update_batch(c, x, lo, hi)))
    want = upd(jnp.zeros((6, bins)), J(xs))
    got = tsk.hist_update_batch(tsk.hist_init(bins, (6,), "cpu"), T(xs), lo, hi)
    exact(got, want)
    for p in (0.1, 0.5, 0.9):
        q = jax.jit(jax.vmap(lambda c: jsk.hist_quantile(c, p, lo, hi)))
        close(tsk.hist_quantile(got, p, lo, hi), q(want), f"q{p}")
    one = jax.jit(lambda c, x: jsk.hist_update(c, x, lo, hi))
    exact(tsk.hist_update(got[0], T(xs[0, 5]), lo, hi),
          one(want[0], J(xs[0, 5])))
    exact(tsk.hist_merge(got), jsk.hist_merge(want))
    empty = tsk.hist_quantile(tsk.hist_init(bins, (2,), "cpu"), 0.5, lo, hi)
    exact(empty, np.full(2, lo, np.float32))


def test_p2_matches_jax():
    """Thirty observations per row through P² (warm-up on +inf heights,
    then the parabolic / linear steps): positions and counts exact,
    heights and the estimate within the band at every step."""
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(30, 6)).astype(np.float32)
    xs[:, 0] = 0.25                      # ties in one row
    step = jax.jit(jax.vmap(lambda s, x: jsk.p2_update(s, x, 0.5)))
    val = jax.jit(jax.vmap(jsk.p2_value))
    js = jax.vmap(lambda _: jsk.p2_init(0.5))(jnp.arange(6))
    ts = tsk.p2_init(0.5, (6,), "cpu")
    for t in range(30):
        js, ts = step(js, J(xs[t])), tsk.p2_update(ts, T(xs[t]), 0.5)
        exact(ts.n, js.n, f"n{t}")
        exact(ts.npos, js.npos, f"npos{t}")
        exact(ts.count, js.count, f"count{t}")
        close(ts.q, js.q, f"q{t}")
        close(tsk.p2_value(ts), val(js), f"value{t}")


def drift_run(xs, dk):
    """JAX's and the port's detector over the (steps, B) stream ``xs``."""
    upd = jax.jit(jax.vmap(lambda s, x: jdrift.drift_update(s, x, **dk)))
    js = jax.vmap(lambda _: jdrift.drift_init())(jnp.arange(xs.shape[1]))
    ts = tdrift.drift_init((xs.shape[1],), "cpu")
    out = []
    for t, x in enumerate(xs):
        if t % 10 == 0:
            js = jax.vmap(jdrift.drift_reset_episode)(js)
            ts = tdrift.drift_reset_episode(ts)
        js, ts = upd(js, J(x)), tdrift.drift_update(ts, T(x), **dk)
        out.append((np_fields(js), t_fields(ts)))
    return out


def test_drift_matches_jax():
    """CUSUM and Page–Hinkley over streams with a step shift, a slow ramp
    and a constant warm-up: alarms (``flag``) exact, or a flip at a
    statistic within float32 roundoff of 1.0 (reported), after which that
    channel alone leaves the comparison; the floats of every other
    channel within the band at every sample."""
    rng = np.random.default_rng(4)
    n = 80
    base = rng.normal(0.0, 0.1, (n, 6)).astype(np.float32)
    base[40:, 0] += 2.0                              # step shift
    base[:, 1] += np.linspace(0, 3, n, dtype=np.float32)   # ramp
    base[:, 2] = 0.5                                 # constant
    base[55:, 3] -= 1.0
    fired = 0
    live = np.ones(base.shape[1], bool)
    for t, (want, got) in enumerate(drift_run(base, DK)):
        diff = live & (got["flag"] != want["flag"])
        if diff.any():
            score = want["score"][diff]
            assert np.all(np.abs(score - 1.0) < 1e-5), (t, score)
            print(f"drift near-tie at sample {t}, channels "
                  f"{np.flatnonzero(diff)}: score {score}")
            live &= ~diff
        fired += int(want["flag"][live].sum())
        for k, v in want.items():
            close(got[k][live], v[live], f"{k}@{t}")
    assert fired > 0 and live.sum() >= base.shape[1] - 1


def susp_float64(deltas, sel):
    """``attribution_scores``' suspicion in float64 (numpy), with the
    leave-one-out reference formed directly."""
    a = len(sel)
    f = np.concatenate([deltas[k].reshape(a, -1) for k in sorted(deltas)],
                       1).astype(np.float64)
    norms = np.sqrt((f * f).sum(1))
    picked = np.sort(norms[sel])
    med = picked[(len(picked) - 1) // 2]
    w = sel * np.minimum((med / np.maximum(norms, 1e-12)) ** 2, 1.0)
    r = w @ f
    loo = r[None] - w[:, None] * f
    cos = f @ r / np.maximum(norms * np.linalg.norm(r), 1e-12)
    cos_loo = (f * loo).sum(1) / np.maximum(
        norms * np.linalg.norm(loo, axis=1), 1e-12)
    log_r = np.maximum(np.log(np.maximum(norms, 1e-12) / med), 0.0)
    susp = (tattr.W_COS_LOO * (1 - np.clip(cos_loo, -1, 1)) / 2
            + tattr.W_COS * (1 - np.clip(cos, -1, 1)) / 2
            + tattr.W_NORM * log_r / (1 + log_r))
    return np.clip(susp, 0, 1) * sel, (loo * loo).sum(1) / (r @ r)


def test_attribution_in_band_down_to_a_loo_share_of_1e_4(capsys):
    """The closed-form leave-one-out cosine cancels when a client's
    leave-one-out reference is a small share of the reference (two
    selected clients, one ``k`` times the other's norm: share ~1/k^2).
    Down to a share of 1e-4 the float32 suspicion stays within rtol 1e-3
    / atol 1e-4 of float64, the band in which the card is held against
    the CPU; below it float32 departs (printed)."""
    rng = np.random.default_rng(8)
    sel = np.array([True, True, False, False])
    for k in (3.0, 10.0, 90.0, 1e4):
        deltas = {n: rng.normal(size=(4, *shape)).astype(np.float32)
                  for n, shape in (("w", (48, 16)), ("b", (16,)))}
        for v in deltas.values():
            v[1] *= k
        want, share = susp_float64(deltas, sel)
        got = tattr.attribution_scores({n: T(v) for n, v in deltas.items()},
                                       T(sel))["susp"].numpy()
        with capsys.disabled():
            print(f"\nshare {share[0]:.2e}: float32 suspicion {got[0]:.6g}"
                  f", float64 {want[0]:.6g}")
        if share[0] >= 1e-4:
            close(got, want, f"k={k}", rtol=1e-3, atol=1e-4)


def test_attribution_matches_jax():
    """Scores of 12-leaf deltas (two sign-flipped at 25x, one at honest
    scale, unselected clients) against JAX's, at odd and even selection
    counts; the lower median exact."""
    rng = np.random.default_rng(5)
    a = 8
    shapes = {"w0": (8, 64), "b0": (64,), "w1": (64, 48), "b1": (48,),
              "head_res/w": (48, 4), "head_res/b": (4,),
              "head_bs/w": (48, 7), "head_bs/b": (7,), "head_mt/w": (48, 4),
              "head_mt/b": (4,), "value/w": (48, 1), "value/b": (1,)}
    honest = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    deltas = {k: (v + 0.3 * rng.normal(size=(a, *v.shape))).astype(
        np.float32) for k, v in honest.items()}
    for k in deltas:
        deltas[k][2] *= -25.0
        deltas[k][5] *= -1.0
    fn = jax.jit(jattr.attribution_scores)
    for sel in ([1, 1, 1, 1, 1, 1, 1, 1], [1, 0, 1, 1, 0, 1, 0, 1],
                [0, 0, 1, 0, 0, 0, 0, 0], [0] * 8):
        sel = np.array(sel, bool)
        want = fn({k: J(v) for k, v in deltas.items()}, J(sel))
        got = tattr.attribution_scores({k: T(v) for k, v in deltas.items()},
                                       T(sel))
        for k, v in want.items():
            close(got[k], v, k)
        norms = np.asarray(want["norm"])
        exact(tattr._masked_lower_median(T(norms), T(sel)),
              jattr._masked_lower_median(J(norms), J(sel)))
        close(tattr.robust_reference_weights(T(norms), T(sel)),
              jattr.robust_reference_weights(J(norms), J(sel)))
    assert float(got["susp"].sum()) == 0.0          # nothing selected


def telemetry(rng, a, t, k):
    probs = rng.dirichlet(np.ones(k), (a, t)).astype(np.float32)
    return (np.tanh(rng.normal(-0.3, 0.6, (a, t))).astype(np.float32),
            rng.uniform(-0.05, 1.05, (a, t)).astype(np.float32), probs,
            rng.uniform(5.0, 160.0, (a, t)).astype(np.float32))


@pytest.mark.parametrize("bins,stride", [(16, 10), (10, 5)])
def test_update_episode_and_summaries_match_jax(bins, stride):
    """Twelve episodes of telemetry (a reward shift after six) through
    ``update_episode``, ``episode_summaries`` and ``update_round``:
    counts, positions and drift flags exact, floats within the band."""
    rng = np.random.default_rng(bins)
    a, t, k = 5, 10, 15
    kw = dict(bins=bins, stride=stride, warmup=3, cusum_h=2.0,
              ph_lambda=3.0)
    jc, tc = jh.HealthConfig(**kw), th.HealthConfig(**kw)
    upd = jax.jit(lambda s, *x: jh.update_episode(jc, s, *x))
    summ = jax.jit(lambda s: jh.episode_summaries(jc, s))
    rnd = jax.jit(lambda s, x, m: jh.update_round(jc, s, x, m))
    js, ts = jh.health_init(jc, a, k), th.health_init(tc, a, k, "cpu")
    alarms = 0
    for e in range(12):
        tele = telemetry(rng, a, t, k)
        if e >= 6:
            tele = (np.clip(tele[0] + 0.8, -1, 1), *tele[1:])
        js, ts = upd(js, *map(J, tele)), th.update_episode(tc, ts,
                                                           *map(T, tele))
        got, want = t_fields(ts), np_fields(js)
        for f in ("reward_hist", "miss_hist", "n_obs"):
            exact(got[f], want[f], f)
        exact(got["reward_p2"]["n"], want["reward_p2"]["n"])
        for ch in ("drift_reward", "drift_rate"):
            exact(got[ch]["flag"], want[ch]["flag"], f"{ch}.flag@{e}")
            alarms += int(want[ch]["flag"].sum())
            for f, v in want[ch].items():
                close(got[ch][f], v, f"{ch}.{f}@{e}")
        close(got["act_sum"], want["act_sum"])
        close(got["reward_p2"]["q"], want["reward_p2"]["q"])
        for key, v in summ(js).items():
            close(th.episode_summaries(tc, ts)[key], v, key)
        susp = rng.uniform(0, 1, a).astype(np.float32)
        sel = rng.random(a) < 0.6
        js, ts = rnd(js, J(susp), J(sel)), th.update_round(tc, ts, T(susp),
                                                           T(sel))
        for f in ("susp", "susp_last", "sel_last"):
            close(getattr(ts, f), getattr(js, f), f)
    assert alarms > 0                               # the shift alarmed
    assert set(th.episode_summaries(tc, ts)) == set(jh.HEALTH_METRIC_KEYS)
    assert th.HEALTH_METRIC_KEYS == jh.HEALTH_METRIC_KEYS


def test_update_episode_rejects_an_indivisible_stride():
    tc = th.HealthConfig(stride=3)
    st = th.health_init(tc, 2, 15, "cpu")
    x = torch.zeros(2, 10)
    with pytest.raises(ValueError, match="not a multiple of HealthConfig"):
        th.update_episode(tc, st, x, x, torch.zeros(2, 10, 15), x)


@pytest.mark.parametrize("kw", [
    dict(bins=1), dict(reward_lo=1.0, reward_hi=1.0), dict(cusum_h=0.0),
    dict(var_floor=-1.0), dict(ema_fast=1.5), dict(susp_beta=0.0),
    dict(warmup=0), dict(stride=0)])
def test_health_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        jh.HealthConfig(**kw)
    with pytest.raises(ValueError) as got:
        th.HealthConfig(**kw)
    assert str(got.value) == str(want.value)
    assert dataclasses.asdict(th.HealthConfig()) == \
        dataclasses.asdict(jh.HealthConfig())


def test_health_state_is_93_floats_an_agent():
    """372 B an agent at ``bins=16`` (2,976 B at A=8), JAX's count, and
    float32 under every state policy."""
    tc, cfg = th.HealthConfig(), TCfg()
    # two 16-bin histograms, P²'s 16 values, 15 action marginals, n_obs,
    # two drift channels of 13, three suspicion values
    assert (2 * 16 + 16 + 15 + 1 + 2 * 13 + 3) * 4 * 8 == 2976
    assert jfleet.fleet_state_bytes(jfleet.fleet_init(
        JCfg(), 8, jax.random.PRNGKey(0), n_pods=2, state_policy="lean",
        health=jh.HealthConfig()))["health"] == 2976.0
    for policy in (None, "bf16", "lean"):
        fleet = tfleet.fleet_init(cfg, 8, 0, n_pods=2, device="cpu",
                                  state_policy=policy, health=tc)
        assert tfleet.fleet_state_bytes(fleet)["health"] == 2976.0
        assert all(v.dtype == np.float32
                   for v in jax.tree.leaves(t_fields(fleet.health)))


# ---------------------------------------------------------------------------
# The suspicion gate
# ---------------------------------------------------------------------------
def test_suspicion_gate_matches_jax():
    rng = np.random.default_rng(6)
    for _ in range(20):
        sel = rng.random(8) < 0.6
        susp = rng.uniform(0, 1, 8).astype(np.float32)
        susp[0] = 0.5                                   # at the threshold
        g_t, n_t = tguards.suspicion_gate(T(sel), T(susp), 0.5)
        g_j, n_j = jguards.suspicion_gate(J(sel), J(susp), 0.5)
        exact(g_t, g_j)
        exact(n_t, n_j)


@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.5, 0.9])
def test_select_clients_with_suspicion_matches_jax(threshold):
    """Suspects leave the pool before the top-k and their slots go to the
    next candidates: JAX's selection exactly, stragglers included."""
    rng = np.random.default_rng(7)
    cfg_j, cfg_t = JCfg(), TCfg()
    for _ in range(10):
        f = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
        avail = rng.random(10) < 0.8
        stats = [f(10), f(10), f(10) * 3, f(10) * 40, avail]
        susp = f(10)
        want = jfed.select_clients(cfg_j, jfed.ClientStats(*map(J, stats)),
                                   suspicion=J(susp),
                                   susp_threshold=threshold)
        got = tfed.select_clients(cfg_t, tfed.ClientStats(*map(T, stats)),
                                  suspicion=T(susp),
                                  susp_threshold=threshold)
        exact(got, want)


def test_guard_config_takes_a_threshold():
    assert tguards.GuardConfig(susp_threshold=0.5).susp_threshold == 0.5
    with pytest.raises(ValueError, match=r"susp_threshold must be in \[0"):
        tguards.GuardConfig(susp_threshold=1.5)


# ---------------------------------------------------------------------------
# Both drivers with health against JAX
# ---------------------------------------------------------------------------
A, P, N_EPS = 8, 2, 8
CFG_J, CFG_T = JCfg(fl_every=1), TCfg(fl_every=1)
BACKENDS = {"fluid": (None, None),
            "twin": (JTwin(sp=JSimParams()), TwinBackend(sp=SimParams()))}
SENSITIVE = dict(warmup=2, cusum_h=1.5, ph_lambda=3.0)


def run_kwargs(pkg, threshold, hcfg=None):
    tr, fa, gd, hh = ((jtr, jfaults, jguards, jh) if pkg == "jax"
                      else (ttr, tfaults, tguards, th))
    return dict(transport=tr.TransportConfig(codec="int8", deadline_s=0.002),
                faults=fa.FaultConfig(byzantine_frac=0.25, seed=0),
                guards=gd.GuardConfig(susp_threshold=threshold),
                health=hh.HealthConfig(**(hcfg or {})),
                straggler_prob=0.25, seed=3)


def health_tree(jf):
    return np_fields(jf.health)


_JAX_RUNS = {}


def jax_run(backend, threshold, hcfg=None):
    """JAX's health run in one-episode calls (the uninterrupted run's
    numbers, by ``episode_offset``), recording each round's aggregation
    mask (``health.sel_last``). Cached per configuration."""
    key = (backend, threshold, tuple(sorted((hcfg or {}).items())))
    if key not in _JAX_RUNS:
        jb = BACKENDS[backend][0]
        jf0 = jfleet.fleet_init(CFG_J, A, jax.random.PRNGKey(1), n_pods=P,
                                env_backend=jb,
                                health=jh.HealthConfig(**(hcfg or {})))
        traces = np.random.default_rng(2).uniform(
            5.0, 160.0, (A, N_EPS * CFG_J.n_steps)).astype(np.float32)
        jf, hists, sels = jf0, [], []
        n = CFG_J.n_steps
        for e in range(N_EPS):
            jf, h = jfleet.train_fleet_scan(
                CFG_J, jf, J(traces[:, e * n:(e + 1) * n]), env_backend=jb,
                episode_offset=e, total_episodes=N_EPS,
                **run_kwargs("jax", threshold, hcfg))
            hists.append(h)
            sels.append(np.asarray(jf.health.sel_last))
        hist = {k: np.concatenate([h[k] for h in hists]) for k in hists[0]}
        rngs, noise = jf0.astate.rng, []
        for _ in range(N_EPS):
            g, rngs = jax_episode_noise(rngs, n, head_sizes(CFG_J))
            noise.append(np.asarray(g))
        tree = jax_fleet_tree(jf0)
        tree["health"] = health_tree(jf0)
        _JAX_RUNS[key] = dict(tree=tree, traces=traces, hist=hist,
                              sels=np.stack(sels), fleet=jf,
                              gumbel=torch.tensor(np.stack(noise)))
    return _JAX_RUNS[key]


def port_run(drive, backend, threshold, run, hcfg=None, **extra):
    """One port driver from JAX's initial fleet with its noise; returns
    (history, each round's aggregation mask, final fleet)."""
    sels, orig = [], tfleet.fl_round

    def recording(*args, **kw):
        out = orig(*args, **kw)
        sels.append(out[0].health.sel_last.clone().numpy())
        return out
    tfleet.fl_round = recording
    try:
        tf = tfleet.fleet_from_numpy(CFG_T, run["tree"], device="cpu")
        tf, hist = drive(CFG_T, tf, T(run["traces"]),
                         env_backend=BACKENDS[backend][1],
                         gumbel=run["gumbel"],
                         **run_kwargs("torch", threshold, hcfg), **extra)
    finally:
        tfleet.fl_round = orig
    return hist, np.stack(sels), tf


SUSP_BAND = dict(rtol=1e-3, atol=1e-4)


def check_against_jax(hist, sels, tf, run):
    want_h = run["hist"]
    assert set(hist) == set(want_h)
    for k in ("fl_missed", "fl_rejected", "fl_payload_bytes",
              "health_drift_flag"):
        exact(hist[k], want_h[k], k)
    for k, v in want_h.items():
        close(hist[k], v, k, **(SUSP_BAND if k == "health_susp" else {}))
    exact(sels, run["sels"], "per-round selections")
    got, want = tfleet.fleet_to_numpy(tf), jax_fleet_tree(run["fleet"])
    exact(got["buffer"]["actions"], want["buffer"]["actions"], "actions")
    exact(got["env_state"]["cur_action"], want["env_state"]["cur_action"])
    gh, wh = got["health"], health_tree(run["fleet"])
    for f in ("reward_hist", "miss_hist", "n_obs", "sel_last"):
        exact(gh[f], wh[f], f)
    exact(gh["reward_p2"]["n"], wh["reward_p2"]["n"])
    for ch in ("drift_reward", "drift_rate"):
        exact(gh[ch]["flag"], wh[ch]["flag"], ch)
        for f, v in wh[ch].items():
            close(gh[ch][f], v, f"{ch}.{f}")
    close(gh["reward_p2"]["q"], wh["reward_p2"]["q"])
    close(gh["act_sum"], wh["act_sum"])
    for f in ("susp", "susp_last"):
        close(gh[f], wh[f], f, **SUSP_BAND)


@pytest.mark.parametrize("backend,hcfg", [
    ("fluid", None), ("twin", None), ("fluid", SENSITIVE)],
    ids=["fluid", "twin", "fluid-sensitive-detectors"])
def test_health_run_matches_jax(backend, hcfg):
    """The slice's run through both port drivers against JAX (see the
    module docstring); ``sensitive`` detectors (warm-up 2, h 1.5, lambda
    3) make the drift flags fire within the eight episodes."""
    run = jax_run(backend, 0.0, hcfg)
    out = [port_run(drive, backend, 0.0, run, hcfg)
           for drive in (tfleet.train_fleet_scan,
                         tfleet.train_fleet_reference)]
    (h_s, sel_s, f_s), (h_r, sel_r, f_r) = out
    for k, v in h_r.items():
        np.testing.assert_array_equal(h_s[k], np.float32(v), err_msg=k)
    exact(sel_s, sel_r)
    for name, v in jax.tree_util.tree_leaves_with_path(
            tfleet.fleet_to_numpy(f_r)):
        got = jax.tree_util.tree_leaves_with_path(tfleet.fleet_to_numpy(f_s))
        np.testing.assert_array_equal(dict(got)[name], v, err_msg=str(name))
    check_against_jax(h_s, sel_s, f_s, run)
    if hcfg:
        assert run["hist"]["health_drift_flag"].any()


def test_suspicion_gate_selects_jax_clients():
    """The health run at ``susp_threshold=0.5``: every round's aggregation
    mask is JAX's, and the gate drops a client the ungated run kept."""
    run = jax_run("fluid", 0.5)
    hist, sels, tf = port_run(tfleet.train_fleet_scan, "fluid", 0.5, run)
    check_against_jax(hist, sels, tf, run)
    assert not np.array_equal(sels, jax_run("fluid", 0.0)["sels"])


NON_HEALTH = lambda fleet: {
    k: v for k, v in jax.tree_util.tree_leaves_with_path(
        tfleet.fleet_to_numpy(fleet)) if "health" not in str(k[0])}


@pytest.mark.parametrize("backend", ["fluid", "twin"])
@pytest.mark.parametrize("codec", ["float32", "int8"])
def test_health_off_is_bit_identical(backend, codec):
    """With ``susp_threshold=0``, health on leaves every non-health history
    key and all non-health state bit for bit as health off, under both
    drivers (the counterpart of JAX's
    ``test_health_off_is_bit_identical``); the plain float32 round scores
    ``params - base`` on the side."""
    tb = BACKENDS[backend][1]
    traces = T(np.random.default_rng(8).uniform(5.0, 160.0, (4, 40)).astype(
        np.float32))
    for drive in (tfleet.train_fleet_scan, tfleet.train_fleet_reference):
        runs = []
        for health in (None, th.HealthConfig()):
            fleet = tfleet.fleet_init(CFG_T, 4, 5, n_pods=2, device="cpu",
                                      env_backend=tb)
            fleet, hist = drive(
                CFG_T, fleet, traces, straggler_prob=0.25, seed=3,
                env_backend=tb, health=health,
                transport=ttr.TransportConfig(codec=codec))
            runs.append((hist, NON_HEALTH(fleet), fleet))
        (h0, s0, f0), (h1, s1, f1) = runs
        assert f0.health is None and f1.health is not None
        assert set(h1) == set(h0) | set(th.HEALTH_METRIC_KEYS)
        for k, v in h0.items():
            np.testing.assert_array_equal(h1[k], v, err_msg=k)
        assert s0.keys() == s1.keys()
        for k, v in s0.items():
            np.testing.assert_array_equal(s1[k], v, err_msg=str(k))
        assert float(f1.health.n_obs[0]) == 40.0
        assert (h1["health_susp"][1:] > 0).all()


def test_ensure_health_attaches_fresh_state_in_place():
    """A fleet without health state gets fresh state when a driver is given
    a ``HealthConfig``; a fleet with state keeps it."""
    fleet = tfleet.fleet_init(CFG_T, 4, 0, device="cpu")
    traces = torch.full((4, 20), 50.0)
    out, hist = tfleet.train_fleet_scan(CFG_T, fleet, traces,
                                        health=th.HealthConfig())
    assert out is fleet and fleet.health is not None
    assert float(fleet.health.n_obs[0]) == 20.0
    kept = fleet.health.reward_hist
    out, _ = tfleet.train_fleet_reference(CFG_T, fleet, traces,
                                          health=th.HealthConfig())
    assert out.health.reward_hist.sum() == 2 * kept.sum()
    with pytest.raises(ValueError, match="needs a fleet with health"):
        tfleet.fleet_episode(CFG_T, tfleet.fleet_init(CFG_T, 2, 0,
                                                      device="cpu"),
                             torch.ones(2, 10), health=th.HealthConfig())


class OpCount(TorchDispatchMode):
    """Counts the non-view ops a body dispatches (on the CPU here; each
    is at most one kernel on the card)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and func is not torch.ops.aten.detach.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


# (episode body, round body) ops without health or sink, as the port
# dispatched them before it had health state, counted by
# ``body_op_counts``
PARENT_BODY_OPS = {("fluid", "float32"): [3817, 1150],
                   ("fluid", "int8"): [3817, 1354],
                   ("twin", "float32"): [22360, 1152],
                   ("twin", "int8"): [22360, 1356]}


class NullSink:
    def append(self, record):
        pass


def body_op_counts(backend, codec, health=None, sink=None):
    """The ops the graph driver's episode and FL-round bodies dispatch
    (A=8, P=2, after four episodes)."""
    cfg = TCfg()
    driver = tfleet.FleetScan(
        cfg, tfleet.fleet_init(cfg, 8, 0, n_pods=2, device="cpu",
                               env_backend=backend),
        torch.full((8, 60), 60.0), env_backend=backend, health=health,
        metrics_sink=sink, transport=ttr.TransportConfig(codec=codec))
    for _ in range(4):
        driver.step()
    out = []
    for graph in driver.graphs[:2]:
        with OpCount() as c:
            graph.body()
        out.append(c.n)
    return out


@pytest.mark.parametrize("backend,codec", [
    pytest.param("fluid", "float32", id="float32"),
    pytest.param("fluid", "int8", id="int8"),
    pytest.param("twin", "float32", id="twin-float32"),
    pytest.param("twin", "int8", id="twin-int8")])
def test_health_and_sink_op_counts(backend, codec, capsys):
    """The ops the episode and FL-round bodies of the graph driver
    dispatch (A=8, P=2): without health or sink exactly the parent
    port's, a metrics sink adds none to either body (its copies run
    between replays), and ``--health`` adds a bounded number
    (printed)."""
    counts = {(health is not None, sink is not None):
              body_op_counts(backend, codec, health, sink)
              for health in (None, th.HealthConfig())
              for sink in (None, NullSink())}
    assert counts[False, False] == PARENT_BODY_OPS[backend, codec]
    assert counts[False, True] == counts[False, False]
    assert counts[True, True] == counts[True, False]
    (e0, r0), (e1, r1) = counts[False, False], counts[True, False]
    with capsys.disabled():
        print(f"\n{backend} {codec}: episode body {e0} -> {e1} ops "
              f"(+{e1 - e0}), round body {r0} -> {r1} (+{r1 - r0})")
    assert 400 <= e1 - e0 <= 600 and 150 <= r1 - r0 <= 300

