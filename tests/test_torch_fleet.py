"""The whole slice: the port's fleet driver against
``repro.core.fleet.train_fleet_reference`` on the CPU, plus ``fl_round``,
the state carry-over and the CLI.

Both packages start from the identical fleet (the JAX fleet's state carried
across as numpy), run the same traces, and the port replays JAX's Gumbel
action noise, rebuilt from the fleet's keys. A=4 agents, P=2 pods,
``fl_every=1`` so that the 4th round triggers a pod merge, five episodes;
float32 codec, and int8 with a round deadline and Bernoulli stragglers.
Histories and final state within rtol 1e-4 / atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import fleet as jfleet
from repro.core.backends import FLUID
from repro.fl import transport as jtr
from repro.resilience.guards import DEFAULT_GUARDS
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import fleet as tfleet
from repro_torch.fl import transport as ttr
from repro_torch.kernels.diversity import diversity_insert
from test_torch_support import (close, close_state, close_tree, exact,
                                head_sizes, jax_episode_noise,
                                jax_fleet_tree, to_rollout)

A, P, N_EPS = 4, 2, 5
CFG_J, CFG_T = JCfg(fl_every=1), TCfg(fl_every=1)
# the deadline drops the slowest links of the int8 uploads (~4.6 KB)
TRANSPORTS = {"float32": dict(codec="float32"),
              "int8": dict(codec="int8", deadline_s=0.002)}


@pytest.fixture(scope="module")
def jax_fleet():
    """One JAX fleet for the whole module (an eager ``fleet_init``
    compiles dozens of small programs per fleet size)."""
    return jfleet.fleet_init(CFG_J, A, jax.random.PRNGKey(0), n_pods=P)


@pytest.fixture(scope="module")
def traces():
    rng = np.random.default_rng(0)
    return rng.uniform(5.0, 160.0, (A, N_EPS * CFG_J.n_steps)).astype(
        np.float32)


def test_fleet_numpy_round_trip(jax_fleet):
    """fleet_from_numpy(JAX state) -> fleet_to_numpy gives every leaf
    back: the two packages start from identical state."""
    tree = jax_fleet_tree(jax_fleet)
    back = tfleet.fleet_to_numpy(
        tfleet.fleet_from_numpy(CFG_T, tree, device="cpu"))
    for key in ("params", "opt", "buffer", "env_state", "env_params",
                "base_params", "masks", "residuals", "pending"):
        close_tree(back[key], tree[key], key + ".")
    for key in ("crash_timer", "partition_timer"):
        exact(back[key], tree[key], key)
    exact(back["speeds"], tree["speeds"])
    exact(back["bandwidth"], tree["bandwidth"])


def test_fleet_init_draws_the_reference_device_mix():
    """Speeds and bandwidths come from the reference's numpy streams."""
    f = tfleet.fleet_init(CFG_T, 6, 0, n_pods=2, device="cpu")
    exact(f.speeds, np.random.default_rng(0).choice(
        [0.5, 0.75, 1.0, 2.0], 6).astype(np.float32))
    close(f.bandwidth, np.random.default_rng(1).uniform(2.0, 40.0, 6))
    exact(f.pod_ids, np.arange(6) % 2)
    base = f.base.params()
    for k, v in base.items():
        assert torch.equal(v[0], v[1]), k       # pods start from one base


@pytest.mark.parametrize("codec,poison", [("float32", False),
                                          ("int8", False),
                                          ("float32", True)])
def test_fl_round_matches_jax(jax_fleet, codec, poison):
    """One round after one episode, with a straggler: selection, the codec
    path (int8 with a deadline that drops slow links), Alg. 1, Alg. 2, the
    buffer resync and the round metrics. ``poison``: three agents carry a
    NaN weight and must be rejected from aggregation (``fl_rejected``)."""
    rates = jnp.asarray(np.random.default_rng(3).uniform(5, 150, (A, 10)),
                        jnp.float32)
    jf, roll_j, _ = jfleet.fleet_episode(CFG_J, jax_fleet, rates,
                                         learn=True, backend=FLUID,
                                         health=None)
    avail = np.array([1, 0, 1, 1], bool)
    if poison:
        w = jf.astate.params["head_bs"]["w"].at[jnp.array([0, 2, 3]), 0,
                                                0].set(jnp.nan)
        params = dict(jf.astate.params, head_bs=dict(
            jf.astate.params["head_bs"], w=w))
        jf = jf._replace(astate=jf.astate._replace(params=params))
        avail[:] = True
    tf = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(jf), device="cpu")
    jf2, sel_j, met_j = jfleet.fl_round(
        CFG_J, jf, roll_j, jnp.asarray(avail),
        transport=jtr.TransportConfig(**TRANSPORTS[codec]),
        guards=DEFAULT_GUARDS, faults=None, byzantine=None, fault_key=None,
        health=None)
    tf2, sel_t, met_t = tfleet.fl_round(
        CFG_T, tf, to_rollout(roll_j), torch.tensor(avail),
        transport=ttr.TransportConfig(**TRANSPORTS[codec]))
    exact(sel_t, sel_j)
    for k, v in met_t.items():
        close(v, met_j[k], k)
    if codec == "int8":
        assert float(met_j["fl_missed"]) > 0      # the deadline bites
    got, want = tfleet.fleet_to_numpy(tf2), jax_fleet_tree(jf2)
    if poison:
        # the rejected agents' NaN never reaches an aggregate in the port;
        # the reference's head sums multiply them by a zero weight, which
        # leaves NaN in its head_bs bases (a reference fault, ROADMAP
        # queue 3). A poisoned agent in a pod with no contributor keeps its
        # own (NaN) head by Alg. 1's fallback, in both packages.
        assert float(met_t["fl_rejected"]) >= 1
        fed_pods = tf2.pod_ids[sel_t].unique()
        healthy = torch.isin(tf2.pod_ids, fed_pods)
        for name, t in tf2.astate.policy.params().items():
            assert torch.isfinite(t[healthy]).all(), name
        for name, t in tf2.base.params().items():
            assert torch.isfinite(t).all(), name
        for key in ("params", "base_params"):
            for part in ("backbone", "value"):
                close_tree(got[key][part], want[key][part], f"{key}.{part}.")
        close_tree(got["buffer"], want["buffer"], "buffer.")
        return
    close_state(got, want, ("params", "opt", "base_params", "residuals",
                            "buffer"), codec)


@pytest.mark.parametrize("codec", ["float32", "int8"])
def test_train_fleet_reference_matches_jax(jax_fleet, traces, codec):
    """The port's driver == the JAX reference driver over five episodes:
    per-episode histories, then the final params, optimizer state, base
    networks (after the pod merge), residuals and buffers."""
    jt = jtr.TransportConfig(**TRANSPORTS[codec])
    jf, hist_j = jfleet.train_fleet_reference(
        CFG_J, jax_fleet, jnp.asarray(traces), straggler_prob=0.25, seed=3,
        transport=jt)
    rngs, noise = jax_fleet.astate.rng, []
    for _ in range(N_EPS):
        g, rngs = jax_episode_noise(rngs, CFG_J.n_steps, head_sizes(CFG_J))
        noise.append(np.asarray(g))
    tf = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(jax_fleet),
                                 device="cpu")
    before = diversity_insert.launches
    tf, hist_t = tfleet.train_fleet_reference(
        CFG_T, tf, torch.tensor(traces), straggler_prob=0.25, seed=3,
        transport=ttr.TransportConfig(**TRANSPORTS[codec]),
        gumbel=torch.tensor(np.stack(noise)))
    assert diversity_insert.launches == before     # CPU: plain version
    assert set(hist_t) <= set(hist_j)
    for k, v in hist_t.items():
        assert v.shape == (N_EPS,), k
        close(v, hist_j[k], k)
    close_state(tfleet.fleet_to_numpy(tf), jax_fleet_tree(jf),
                ("params", "opt", "base_params", "residuals", "buffer",
                 "env_state"), codec)


@pytest.mark.parametrize("codec", ["float32", "int8", "topk"])
def test_cli_runs_on_the_cpu(codec, capsys):
    from repro_torch.launch import train_fleet
    _, hist = train_fleet.main(["--device", "cpu", "--agents", "4",
                                "--pods", "2", "--episodes", "3",
                                "--fl-every", "1", "--fl-codec", codec])
    assert all(np.isfinite(v).all() and v.shape == (3,)
               for v in hist.values())
    out = capsys.readouterr().out
    assert "reward" in out and f"codec={codec}" in out
    assert (hist["fl_payload_bytes"] > 0).all()
