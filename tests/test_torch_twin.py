"""The twin slice as a whole: training in the twin
(``train_fleet_reference(env_backend="twin")``) against the JAX driver, the
twin fleet's state carry-over, the scenario library and both CLIs, on the
CPU.

Both packages start from the same twin fleet (the JAX fleet's state
carried across as numpy), run the same traces, and the port replays JAX's
Gumbel action noise: A=4 agents, P=2 pods, ``fl_every=1``, three
episodes, float32 and int8 codecs with Bernoulli stragglers. Actions and
the twin state exact, other values within rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import fleet as jfleet
from repro.core.backends import TwinBackend as JTwin
from repro.fl import transport as jtr
from repro.sim import scenarios as jscen
from repro.sim.state import SimParams as JSimParams
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import fleet as tfleet
from repro_torch.core.backends import TwinBackend, TwinEnvState, get_backend
from repro_torch.fl import transport as ttr
from repro_torch.kernels.queue_advance import queue_advance
from repro_torch.sim import scenarios as tscen
from repro_torch.sim.state import SimParams
from test_torch_support import (close, close_state, close_tree, exact,
                                head_sizes, jax_episode_noise,
                                jax_fleet_tree)

A, P, N_EPS = 4, 2, 3
CFG_J, CFG_T = JCfg(fl_every=1), TCfg(fl_every=1)
J_TWIN, T_TWIN = JTwin(sp=JSimParams()), TwinBackend(sp=SimParams())


@pytest.fixture(scope="module")
def jax_fleet():
    return jfleet.fleet_init(CFG_J, A, jax.random.PRNGKey(0), n_pods=P,
                             env_backend=J_TWIN)


@pytest.fixture(scope="module")
def traces():
    rng = np.random.default_rng(0)
    return rng.uniform(5.0, 160.0, (A, N_EPS * CFG_J.n_steps)).astype(
        np.float32)


def port_fleet(tree):
    return tfleet.fleet_from_numpy(CFG_T, tree, device="cpu")


def test_twin_fleet_numpy_round_trip(jax_fleet, traces):
    """After one JAX twin episode the env state is no longer empty; it
    carries across to the port (``sim`` nested, counters int32) and back
    leaf for leaf."""
    jf, _, _ = jfleet.fleet_episode(CFG_J, jax_fleet,
                                    jnp.asarray(traces[:, :10]),
                                    backend=J_TWIN)
    tree = jax_fleet_tree(jf)
    tf = port_fleet(tree)
    env = tf.astate.env_state
    assert isinstance(env, TwinEnvState)
    assert env.sim.counters.dtype == torch.int32
    assert env.cur_action.dtype == torch.long
    assert int(env.sim.completed.sum()) > 0
    back = tfleet.fleet_to_numpy(tf)
    close_tree(back["env_state"], tree["env_state"], "env_state.")
    for f in ("arrive", "counters", "hist"):
        assert back["env_state"]["sim"][f].dtype == np.int32, f


def test_fleet_init_builds_the_twin_and_checks_the_ring():
    f = tfleet.fleet_init(CFG_T, 3, 0, device="cpu", env_backend="twin")
    assert isinstance(f.astate.env_state, TwinEnvState)
    assert f.astate.env_state.sim.arrive.shape == (3, 512)
    with pytest.warns(UserWarning, match="clamps queue_cap"):
        tfleet.fleet_init(CFG_T, 2, 0, device="cpu",
                          env_backend=TwinBackend(sp=SimParams(ring=64)))
    assert get_backend(None).name == "fluid"
    with pytest.raises(ValueError, match="unknown env backend"):
        get_backend("nope")


@pytest.mark.parametrize("codec", ["float32", "int8"])
def test_train_fleet_reference_twin_matches_jax(jax_fleet, traces, codec):
    """The port's driver in the twin == the JAX reference driver over
    three episodes: per-episode histories, then the final params,
    optimizer state, base networks, buffers and the twin env state (its
    ``sim`` and actions exact)."""
    kw = dict(straggler_prob=0.25, seed=3)
    jf, hist_j = jfleet.train_fleet_reference(
        CFG_J, jax_fleet, jnp.asarray(traces), env_backend=J_TWIN,
        transport=jtr.TransportConfig(codec=codec), **kw)
    rngs, noise = jax_fleet.astate.rng, []
    for _ in range(N_EPS):
        g, rngs = jax_episode_noise(rngs, CFG_J.n_steps, head_sizes(CFG_J))
        noise.append(np.asarray(g))
    tf = port_fleet(jax_fleet_tree(jax_fleet))
    before = queue_advance.launches
    tf, hist_t = tfleet.train_fleet_reference(
        CFG_T, tf, torch.tensor(traces), env_backend=T_TWIN,
        transport=ttr.TransportConfig(codec=codec),
        gumbel=torch.tensor(np.stack(noise)), **kw)
    assert queue_advance.launches == before          # CPU: plain version
    assert set(hist_t) <= set(hist_j)
    for k, v in hist_t.items():
        assert v.shape == (N_EPS,), k
        close(v, hist_j[k], k)
    got, want = tfleet.fleet_to_numpy(tf), jax_fleet_tree(jf)
    for k, v in want["env_state"]["sim"].items():
        exact(got["env_state"]["sim"][k], v, f"sim.{k}")
    exact(got["env_state"]["cur_action"], want["env_state"]["cur_action"])
    assert got["env_state"]["sim"]["counters"][:, 9].sum() > 0  # completed
    close_state(got, want, ("params", "opt", "base_params", "residuals",
                            "buffer", "env_state"), codec)


# ---------------------------------------------------------------------------
# the scenario library
# ---------------------------------------------------------------------------
def _agent_keys(key, a):
    return jax.random.split(key, a)


def _fleet_draws_jax(key, a, n, regime_period=120):
    """JAX's draws of ``fleet_traces`` / ``make_trace`` from ``key``."""
    kb, kt = jax.random.split(key)
    regime, noise, burst = [], [], []
    for k in _agent_keys(kt, a):
        k1, k2, k3, _ = jax.random.split(k, 4)
        regime.append(jax.random.uniform(k1, (n // regime_period + 1,)))
        noise.append(jax.random.normal(k2, (n,)))
        burst.append(jax.random.uniform(k3, (n,)))
    return {"base": jax.random.uniform(kb, (a,)), "regime": regime,
            "noise": noise, "burst": burst}


def _noise_jax(key, a, n):
    return [jax.random.normal(k, (n,)) for k in _agent_keys(key, a)]


def jax_scenario_draws(name, key, a, n):
    """The random numbers ``repro.sim.make_scenario(name, key, a, n)``
    draws, under the port's names (``repro_torch.sim.scenarios``)."""
    if name in ("nominal", "steady", "dynamic", "burst"):
        return _fleet_draws_jax(key, a, n)
    if name == "ood":
        return _fleet_draws_jax(key, a, n, regime_period=30)
    if name == "switching":
        k1, k2 = jax.random.split(key)
        return {"src": jax.random.randint(k1, (a, n // max(n // 5, 1) + 1),
                                          0, 3),
                "noise": _noise_jax(k2, a, n)}
    if name == "diurnal":
        kp, kb, kt = jax.random.split(key, 3)
        return {"phase": jax.random.uniform(kp, (a,)),
                "base": jax.random.uniform(kb, (a,)),
                "noise": _noise_jax(kt, a, n)}
    if name == "flash-crowd":
        ks, kb, kt = jax.random.split(key, 3)
        surge = max(int(n * 0.25), 1)
        return {"start": jax.random.randint(ks, (a,), n // 8,
                                            max(n - surge, n // 8 + 1)),
                "base": jax.random.uniform(kb, (a,)),
                "noise": _noise_jax(kt, a, n)}
    if name == "drift":
        kb, kt = jax.random.split(key)
        return {"jitter": jax.random.uniform(kb, (a,)),
                "noise": _noise_jax(kt, a, n)}
    raise AssertionError(name)


@pytest.mark.parametrize("name", tscen.SCENARIOS)
def test_scenario_shaping_matches_jax_on_its_draws(name):
    """The port's shaping arithmetic, fed the draws JAX made from one key,
    gives JAX's traces (300 intervals: three 120-interval regimes, ten OOD
    regimes, five switching segments)."""
    a, n = 3, 300
    key = jax.random.PRNGKey(11)
    want = np.asarray(jscen.make_scenario(name, key, a, n))
    draws = {k: torch.tensor(np.stack([np.asarray(x) for x in v])
                             if isinstance(v, list) else np.asarray(v))
             for k, v in jax_scenario_draws(name, key, a, n).items()}
    got = tscen.shape_scenario(name, draws, n)
    assert got.shape == (a, n) and got.dtype == torch.float32
    close(got, want, name)
    gen = torch.Generator().manual_seed(0)
    drawn = tscen.make_scenario(name, gen, a, n, device="cpu")
    assert drawn.shape == (a, n)
    assert bool(((drawn >= 1.0) & (drawn <= 400.0)).all())


@pytest.mark.parametrize("name", ["dynamic", "ood", "switching", "diurnal",
                                  "flash-crowd", "drift"])
def test_workload_generators_are_the_scenarios(name):
    """Each public generator of ``data/workload.py``, from one seed, gives
    the traces of the scenario that names it."""
    from repro_torch.data import workload as wl
    a, n = 3, 40
    gen = lambda: torch.Generator().manual_seed(5)
    make = {"dynamic": lambda g: wl.fleet_traces(g, a, n, device="cpu",
                                                 **wl.DYNAMIC),
            "ood": lambda g: wl.ood_traces(g, a, n, device="cpu"),
            "switching": lambda g: wl.switching_traces(g, a, n, segment=8,
                                                       device="cpu"),
            "diurnal": lambda g: wl.diurnal_traces(g, a, n, device="cpu"),
            "flash-crowd": lambda g: wl.flash_crowd_traces(g, a, n,
                                                           device="cpu"),
            "drift": lambda g: wl.drift_traces(g, a, n, device="cpu")}[name]
    assert torch.equal(make(gen()),
                       tscen.make_scenario(name, gen(), a, n, device="cpu"))


def test_make_scenario_rejects_unknown_names():
    with pytest.raises(ValueError, match="unknown scenario"):
        tscen.make_scenario("nope", torch.Generator(), 2, 10, device="cpu")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
def test_train_cli_trains_in_the_twin_on_the_cpu(capsys):
    from repro_torch.launch import train_fleet
    _, hist = train_fleet.main(["--device", "cpu", "--agents", "4",
                                "--pods", "2", "--episodes", "2",
                                "--fl-every", "1", "--env-backend", "twin",
                                "--scenario", "dynamic", "--k-ticks", "10"])
    assert all(np.isfinite(v).all() and v.shape == (2,)
               for v in hist.values())
    out = capsys.readouterr().out
    assert "env=twin, scenario=dynamic" in out
    with pytest.raises(SystemExit):
        train_fleet.main(["--device", "cpu", "--ring", "256"])
    assert "--env-backend twin" in capsys.readouterr().err


def test_simulate_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import simulate
    summ = simulate.main(["--device", "cpu", "--agents", "4",
                          "--intervals", "10", "--train-episodes", "1",
                          "--train-backend", "twin", "--compare-fluid"])
    out = capsys.readouterr().out
    assert "scenario=dynamic" in out and "fluid-vs-twin" in out
    for k in ("throughput", "effective_throughput", "p99_latency_s"):
        assert np.isfinite(summ[k]).all() and summ[k].shape == (4,)
    exact(summ["arrived"],
          summ["dropped"] + summ["completed"] + summ["in_flight"])
    assert summ["completed"].sum() > 0


def test_twin_entry_points_need_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    from repro_torch.launch import simulate
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate.main(["--intervals", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tscen.make_scenario("dynamic", torch.Generator(), 2, 10)
