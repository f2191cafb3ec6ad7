"""The compiled drivers on the CPU: the port's ``train_fleet_scan`` (the
graph driver, whose bodies run eagerly on the CPU) against the JAX
package's ``train_fleet_scan`` and against the port's own
``train_fleet_reference``, the CLI's ``--driver``, and the graphed twin
harness against JAX's ``simulate_fleet``.

Both packages start from the identical fleet (the JAX fleet's state carried
across as numpy) and the port replays JAX's Gumbel action noise: A=4
agents, P=2 pods, ``fl_every=1``, four episodes, so that the fourth round
triggers a pod merge. Against JAX: histories and final state within
rtol 1e-4 / atol 1e-5, the twin state and actions exact. Against the
port's reference driver: bit for bit.
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
from repro.sim import harness as jharness
from repro.sim.state import SimParams as JSimParams
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import fleet as tfleet
from repro_torch.core.backends import TwinBackend
from repro_torch.core.crl import EPISODE_METRICS
from repro_torch.core.graphs import GraphedBody, copy_into, full_float32
from repro_torch.fl import transport as ttr
from repro_torch.fl.transport import FL_METRIC_KEYS
from repro_torch.kernels.diversity import diversity_insert
from repro_torch.launch import train_fleet as train_cli
from repro_torch.sim import harness as tharness
from repro_torch.sim.state import SimParams
from test_torch_support import (close, close_state, exact, head_sizes,
                                jax_episode_noise, jax_fleet_tree,
                                jax_sim_noise)

A, P, N_EPS = 4, 2, 4
CFG_J, CFG_T = JCfg(fl_every=1), TCfg(fl_every=1)
J_TWIN, T_TWIN = JTwin(sp=JSimParams()), TwinBackend(sp=SimParams())
BACKENDS = {"fluid": (None, None), "twin": (J_TWIN, T_TWIN)}
# the deadline drops the slowest links of the int8 uploads (~4.6 KB)
TRANSPORTS = {"float32": dict(codec="float32"),
              "int8": dict(codec="int8", deadline_s=0.002),
              "topk": dict(codec="topk")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's CPU runs here are thousands of tiny ops: one intra-op
    thread keeps them from spinning against the other test workers, and
    makes them independent of the machine's core count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_fleets():
    """One JAX fleet per backend for the whole module."""
    key = jax.random.PRNGKey(0)
    return {name: jfleet.fleet_init(CFG_J, A, key, n_pods=P,
                                    env_backend=jb)
            for name, (jb, _) in BACKENDS.items()}


@pytest.fixture(scope="module")
def traces():
    rng = np.random.default_rng(0)
    return rng.uniform(5.0, 160.0, (A, N_EPS * CFG_J.n_steps)).astype(
        np.float32)


def replayed_noise(jf, n_eps=N_EPS):
    """JAX's action noise for ``n_eps`` episodes of ``jf``, as the port's
    ``gumbel`` argument."""
    rngs, noise = jf.astate.rng, []
    for _ in range(n_eps):
        g, rngs = jax_episode_noise(rngs, CFG_J.n_steps, head_sizes(CFG_J))
        noise.append(np.asarray(g))
    return torch.tensor(np.stack(noise))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("backend,codec,learn", [
    ("fluid", "float32", True), ("fluid", "int8", True),
    ("twin", "float32", True), ("fluid", "float32", False)],
    ids=["fluid-float32", "fluid-int8-deadline", "twin-float32", "frozen"])
def test_train_fleet_scan_matches_jax(jax_fleets, traces, backend, codec,
                                      learn):
    """The port's ``train_fleet_scan`` == JAX's ``train_fleet_scan`` over
    four episodes (four rounds and a pod merge when learning; the frozen
    run, ``learn=False, federated=False``, has neither): per-episode
    histories, then the final params, optimizer state, base networks,
    residuals, buffers and env state."""
    jb, tb = BACKENDS[backend]
    jf0 = jax_fleets[backend]
    kw = dict(learn=learn, federated=learn, straggler_prob=0.25, seed=3)
    jf, hist_j = jfleet.train_fleet_scan(
        CFG_J, jf0, jnp.asarray(traces), env_backend=jb,
        transport=jtr.TransportConfig(**TRANSPORTS[codec]), **kw)
    tf = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(jf0), device="cpu")
    before = diversity_insert.launches
    tf, hist_t = tfleet.train_fleet_scan(
        CFG_T, tf, torch.tensor(traces), env_backend=tb,
        transport=ttr.TransportConfig(**TRANSPORTS[codec]),
        gumbel=replayed_noise(jf0), **kw)
    assert diversity_insert.launches == before     # CPU: plain version
    assert set(hist_t) <= set(hist_j)
    for k, v in hist_t.items():
        assert v.shape == (N_EPS,), k
        close(v, hist_j[k], k)
    assert (hist_t["fl_payload_bytes"] > 0).all() == learn
    got, want = tfleet.fleet_to_numpy(tf), jax_fleet_tree(jf)
    if backend == "twin":
        for k, v in want["env_state"]["sim"].items():
            exact(got["env_state"]["sim"][k], v, f"sim.{k}")
        exact(got["env_state"]["cur_action"], want["env_state"]["cur_action"])
    close_state(got, want, ("params", "opt", "base_params", "residuals",
                            "buffer", "env_state"), codec)


@pytest.mark.parametrize("backend", ["fluid", "twin"])
@pytest.mark.parametrize("codec", ["float32", "int8", "topk"])
def test_scan_is_the_reference_bit_for_bit(traces, backend, codec):
    """The port's two drivers on the CPU, from one fresh fleet each, noise
    from the fleets' generators: identical histories and final state, bit
    for bit, through four rounds and a pod merge."""
    tb = BACKENDS[backend][1]
    runs = []
    for drive in (tfleet.train_fleet_reference, tfleet.train_fleet_scan):
        fleet = tfleet.fleet_init(CFG_T, A, 5, n_pods=P, device="cpu",
                                  env_backend=tb)
        fleet, hist = drive(CFG_T, fleet, torch.tensor(traces),
                            straggler_prob=0.25, seed=3, env_backend=tb,
                            transport=ttr.TransportConfig(
                                **TRANSPORTS[codec]))
        runs.append((hist, flat(tfleet.fleet_to_numpy(fleet))))
    (hist_r, state_r), (hist_s, state_s) = runs
    assert set(hist_s) == set(hist_r)
    for k, v in hist_r.items():
        np.testing.assert_array_equal(hist_s[k], v, err_msg=k)
    assert set(state_s) == set(state_r)
    for k, v in state_r.items():
        np.testing.assert_array_equal(state_s[k], v, err_msg=k)
    assert state_s["episode"] == N_EPS


@pytest.mark.parametrize("backend", ["fluid", "twin"])
def test_history_rows_and_the_static_carry(traces, backend):
    """``fl_every=2``: one (n_eps,) array per metric, the FL columns zero on
    the episodes without a round; the fleet's tensors stay the same
    objects (updated in place) and ``train_fleet`` delegates to the scan."""
    tb = BACKENDS[backend][1]
    cfg = TCfg(fl_every=2)
    runs = []
    for drive in (tfleet.train_fleet_scan, tfleet.train_fleet):
        fleet = tfleet.fleet_init(cfg, A, 5, n_pods=P, device="cpu",
                                  env_backend=tb)
        ids = {k: id(v) for k, v in fleet.astate.opt["m"].items()}
        buf, env = fleet.astate.buffer, fleet.astate.env_state
        out, hist = drive(cfg, fleet, torch.tensor(traces), env_backend=tb)
        assert out is fleet and out.episode == N_EPS
        assert out.astate.buffer is buf and out.astate.env_state is env
        assert {k: id(v) for k, v in out.astate.opt["m"].items()} == ids
        runs.append(hist)
    hist = runs[0]
    assert set(hist) == {*EPISODE_METRICS, *FL_METRIC_KEYS}
    for k, v in hist.items():
        assert v.shape == (N_EPS,) and v.dtype == np.float32, k
        np.testing.assert_array_equal(runs[1][k], v, err_msg=k)
    for k in FL_METRIC_KEYS:
        assert (hist[k][0::2] == 0).all(), k        # no round after 1, 3
    assert (hist["fl_payload_bytes"][1::2] > 0).all()


@pytest.mark.parametrize("argv", [
    ["--fl-codec", "int8"],
    ["--fl-codec", "topk", "--straggler-prob", "0.3"],
    ["--env-backend", "twin", "--no-federated"]],
    ids=["int8", "topk-stragglers", "twin-no-fl"])
def test_cli_drivers_give_equal_histories(argv, capsys):
    """``train_fleet.main --driver scan`` (the default) and ``--driver
    reference`` on the CPU: equal histories, the driver in the header."""
    hists = []
    for driver in ("scan", "reference"):
        _, hist = train_cli.main(["--device", "cpu", "--agents", "4",
                                  "--pods", "2", "--episodes", "3",
                                  "--fl-every", "1", *argv,
                                  "--driver", driver])
        assert f"driver={driver}" in capsys.readouterr().out
        hists.append(hist)
    assert set(hists[0]) == set(hists[1])
    for k, v in hists[1].items():
        np.testing.assert_array_equal(hists[0][k], v, err_msg=k)
    assert train_cli.main(["--device", "cpu", "--agents", "2",
                           "--episodes", "1"])[1]["reward"].shape == (1,)
    assert "driver=scan" in capsys.readouterr().out     # the default


def test_graphed_simulate_matches_jax():
    """The port's ``simulate_fleet`` (the interval body the GPU captures,
    run eagerly on the CPU) against JAX's scanned ``simulate_fleet`` at the
    default geometry, replaying JAX's noise: the final state exact, the
    history and summary within the band."""
    from repro.core.fleet import fleet_init as j_fleet_init
    from repro_torch.core.agent import ActionMask, tensors_from_numpy
    from repro_torch.core import env as tenv
    from test_torch_support import np_tree
    a, n_int = 4, 12
    jf = j_fleet_init(CFG_J, a, jax.random.PRNGKey(4))
    traces = np.random.default_rng(8).uniform(5.0, 220.0, (a, n_int)).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    js, jhist, jsumm = jharness.simulate_fleet(
        CFG_J, JSimParams(), jf.astate.params, jf.masks, jf.env_params,
        jnp.asarray(traces), key)
    masks = ActionMask(*(torch.tensor(np.asarray(getattr(jf.masks, k)))
                         for k in ("res", "bs", "mt")))
    tep = tenv.EnvParams(**{k: torch.tensor(np.asarray(v))
                            for k, v in jf.env_params._asdict().items()})
    ts, thist, tsumm = tharness.simulate_fleet(
        CFG_T, SimParams(), tensors_from_numpy(np_tree(jf.astate.params),
                                               "cpu"),
        masks, tep, torch.tensor(traces),
        gumbel=torch.tensor(np.asarray(jax_sim_noise(
            key, n_int, a, head_sizes(CFG_J)))))
    for name, got in zip(("arrive", "counters", "credits", "lat_sum",
                          "hist"), ts.tensors()):
        exact(got, getattr(js, name), name)
    for k, v in thist.items():
        assert v.shape == (n_int, a), k
        close(v, jhist[k], k)
    for k, v in jsumm.items():
        close(tsumm[k], v, k)
    assert int(ts.completed.sum()) > 0


def test_graphed_body_runs_eagerly_on_the_cpu():
    """On the CPU a ``GraphedBody`` runs its body on every call: no graph,
    no capture time, no replays."""
    x = torch.zeros(3)
    body = GraphedBody(lambda: x.add_(1), torch.device("cpu"))
    for _ in range(4):
        body()
    assert torch.equal(x, torch.full((3,), 4.0))
    assert body.graph is None and body.capture_s == 0 and body.replays == 0


def test_copy_into_walks_the_carry_in_place():
    """``copy_into`` copies every tensor of a nested dataclass / dict state
    into the old tensors, skips shared objects, and refuses other types."""
    from repro_torch.core.backends import TwinEnvState
    old = T_TWIN.init(CFG_T, 2, "cpu")
    new = TwinEnvState(sim=old.sim, cur_action=old.cur_action + 2,
                       drops_prev=old.drops_prev + 1, phase=old.phase + 0.5,
                       ema_lat=old.ema_lat)
    keep = old.cur_action
    copy_into(old, new)
    assert old.cur_action is keep and (keep == 2).all()
    assert (old.drops_prev == 1).all() and (old.phase == 0.5).all()
    d = {"a": torch.zeros(2), "b": {"c": torch.zeros(1)}}
    copy_into(d, {"a": torch.ones(2), "b": {"c": torch.ones(1)}})
    assert d["a"].sum() == 2 and d["b"]["c"].sum() == 1
    with pytest.raises(TypeError):
        copy_into([torch.zeros(1)], [torch.ones(1)])


def test_full_float32_turns_tf32_off_and_restores_it():
    """The drivers' products run without TF32 whatever the caller set; the
    caller's settings come back afterwards, also after an error."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with pytest.raises(ValueError):
            with full_float32():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
                raise ValueError
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
