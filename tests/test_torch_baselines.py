"""The paper's baselines (``repro_torch.core.baselines``: BCEdge-, OctopInf-
and Distream-like) against the JAX package's on the CPU, at n=8 replicas
in the fluid MDP and the twin, and ``fleet_init``'s ``masks=`` /
``speeds=`` / ``bandwidth=`` keywords.

BCEdge draws from JAX keys in three places: its device fleet, its
profiling traces and its action noise (offline and at runtime); the test
hands the port JAX's draws, as the fleet tests do. Histories (episode
means) within rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import fleet as jfleet
from repro.core.backends import get_backend as j_backend
from repro.data.workload import PROFILING, fleet_traces
from repro_torch.core import baselines as tbase
from repro_torch.core import fleet as tfleet
from repro_torch.core.agent import ActionMask
from repro_torch.kernels.diversity import diversity_insert
from test_torch_support import close, exact, jax_fleet_tree, jax_joint_noise

N_REP, N_EPS, OFFLINE = 8, 3, 2
BACKENDS = ("fluid", "twin")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traces():
    return np.random.default_rng(0).uniform(
        5.0, 160.0, (N_REP, N_EPS * 10)).astype(np.float32)


def same_history(got, want):
    assert list(got) == list(want) == list(tbase.HISTORY_KEYS)
    for k, v in want.items():
        assert got[k].shape == (N_EPS,), k
        close(got[k], v, k)


def runtime_noise(key, n_int, n_dev, width):
    """JAX's BCEdge runtime noise: ``rng, k = split(rng)`` per interval,
    ``split(k, n_dev)`` per device agent."""
    rng, out = key, []
    for _ in range(n_int):
        rng, k = jax.random.split(rng)
        out.append(np.stack([np.asarray(jax.random.gumbel(kk, (width,)))
                             for kk in jax.random.split(k, n_dev)]))
    return np.stack(out)


def test_bcedge_config_and_masks():
    cfg_t, cfg_j = tbase.bcedge_config(), jbase.bcedge_config()
    assert cfg_t == type(cfg_t)(**{f: getattr(cfg_j, f)
                                   for f in cfg_j.__dataclass_fields__})
    mt, mj = tbase.bcedge_masks(cfg_t, 3, "cpu"), jbase.bcedge_masks(cfg_j, 3)
    for h in ("res", "bs", "mt"):
        exact(getattr(mt, h), getattr(mj, h), h)
    assert cfg_t.n_res + cfg_t.n_bs + cfg_t.n_mt == 13       # K1's NA


def test_fleet_init_takes_masks_speeds_and_bandwidth():
    """The reference's keywords: given values replace the drawn device mix,
    link bandwidths and full masks, and the head groups follow the
    masks."""
    cfg = tbase.bcedge_config()
    m = tbase.bcedge_masks(cfg, 4, "cpu")
    m.res[1] = True                                   # a second res group
    f = tfleet.fleet_init(cfg, 4, 0, masks=m, speeds=np.full(4, 0.5),
                          bandwidth=torch.arange(1.0, 5.0), device="cpu")
    jf = jfleet.fleet_init(
        jbase.bcedge_config(), 4, jax.random.PRNGKey(0),
        masks=jax.tree.map(jnp.asarray, type(jbase.bcedge_masks(
            jbase.bcedge_config(), 4))(*(x.numpy() for x in (
                m.res, m.bs, m.mt)))),
        speeds=jnp.full((4,), 0.5), bandwidth=jnp.arange(1.0, 5.0))
    exact(f.speeds, jf.speeds)
    exact(f.bandwidth, jf.bandwidth)
    for h in ("res", "bs", "mt"):
        exact(getattr(f.masks, h), getattr(jf.masks, h), h)
    for k, ids in f.group_ids.items():
        exact(ids, jf.group_ids[k], k)
        assert f.group_counts[k] == jf.group_counts[k]
    close(f.env_params.t0, jf.env_params.t0)
    assert isinstance(f.masks, ActionMask)
    assert f.astate.buffer.states.shape == (4, 700, 8)


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_bcedge_matches_jax(traces, backend):
    """Two offline episodes on profiling traces (N=700, NA=13 buffers,
    one K1 call each), then the frozen runtime over three episodes, the
    device agents acting on their replicas' mean state."""
    key = jax.random.PRNGKey(3)
    cfg = jbase.bcedge_config()
    want = jbase.run_bcedge(N_REP, jnp.asarray(traces), key,
                            offline_episodes=OFFLINE, seed=1,
                            env_backend=backend)
    n_dev = N_REP // 4
    jf = jfleet.fleet_init(cfg, n_dev, key,
                           masks=jbase.bcedge_masks(cfg, n_dev),
                           speeds=jnp.ones((n_dev,)),
                           env_backend=j_backend(backend))
    prof = fleet_traces(jax.random.fold_in(key, 1), n_dev,
                        OFFLINE * cfg.n_steps, heterogeneity=0.0,
                        **PROFILING)
    rngs, offline = jf.astate.rng, []
    for _ in range(OFFLINE):
        g, rngs = jax_joint_noise(rngs, cfg.n_steps, 56)
        offline.append(np.asarray(g))
    tcfg = tbase.bcedge_config()
    before = diversity_insert.launches
    got = tbase.run_bcedge(
        N_REP, torch.tensor(traces), 3, offline_episodes=OFFLINE, seed=1,
        env_backend=backend, device="cpu",
        fleet=tfleet.fleet_from_numpy(tcfg, jax_fleet_tree(jf),
                                      device="cpu"),
        profiling=np.array(prof), offline_gumbel=torch.tensor(
            np.stack(offline)),
        gumbel=torch.tensor(runtime_noise(key, traces.shape[1], n_dev, 56)))
    assert diversity_insert.launches == before       # CPU: plain version
    same_history(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_octopinf_matches_jax(traces, backend):
    """Re-planned every 10 intervals from the trailing window's mean rate
    (the host grid search and its cache)."""
    want = jbase.run_octopinf(N_REP, jnp.asarray(traces), seed=2, period=10,
                              env_backend=backend)
    got = tbase.run_octopinf(N_REP, torch.tensor(traces), seed=2,
                             period=10, env_backend=backend, device="cpu")
    same_history(got, want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_distream_matches_jax(traces, backend):
    want = jbase.run_distream(N_REP, jnp.asarray(traces), seed=2,
                              env_backend=backend)
    got = tbase.run_distream(N_REP, traces, seed=2, env_backend=backend,
                             device="cpu")
    same_history(got, want)


def test_bcedge_runs_from_its_own_draws():
    """Without JAX's draws the port makes its own (fleet, profiling traces
    and noise from ``key``): finite histories, reproducible per key."""
    tr = torch.full((N_REP, 20), 30.0)
    runs = [tbase.run_bcedge(N_REP, tr, 5, offline_episodes=1, device="cpu")
            for _ in range(2)]
    for k, v in runs[0].items():
        assert v.shape == (2,) and np.isfinite(v).all(), k
        np.testing.assert_array_equal(v, runs[1][k], err_msg=k)
