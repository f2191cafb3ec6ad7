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
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import fleet as jfleet
from repro.core import federated as jfed
from repro.core.backends import TwinBackend as JTwin
from repro.fl import transport as jtr
from repro.resilience import faults as jfaults
from repro.resilience import guards as jguards
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
from repro_torch.resilience import faults as tfaults
from repro_torch.resilience import guards as tguards
from repro_torch.sim import harness as tharness
from repro_torch.sim.state import SimParams
from test_torch_support import (close, close_decoded, close_state, exact,
                                head_sizes, jax_episode_noise,
                                jax_fleet_tree, jax_leaf_noise,
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


# ---------------------------------------------------------------------------
# The chaos layer through both drivers: async rounds, robust Algorithm 1,
# the delta clip, crashes, byzantine uploads and pod partitions
# ---------------------------------------------------------------------------
def chaos_config(pkg, codec="int8", mode="sign_flip"):
    """The slice's configuration in package ``pkg`` (``jax`` or ``torch``):
    async rounds with a deadline that some links miss, the trimmed mean,
    the delta clip, and every fault on."""
    tr, fl = (jtr, jfaults) if pkg == "jax" else (ttr, tfaults)
    gd = jguards if pkg == "jax" else tguards
    deadline = {"int8": 0.002, "topk": 0.0008}[codec]
    return dict(
        transport=tr.TransportConfig(codec=codec, deadline_s=deadline,
                                     async_rounds=True),
        guards=gd.GuardConfig(agg="trimmed", trim_frac=0.2,
                              clip_factor=3.0),
        faults=fl.FaultConfig(crash_prob=0.1, byzantine_frac=0.25,
                              byzantine_mode=mode, byzantine_scale=10.0,
                              partition_prob=0.3, seed=0))


def crash_replayed_noise(jf, plan_crash, recovery, n_eps):
    """JAX's action noise under crashes: an agent down at an episode's
    start gets its pre-episode key back with the rest of its state, so its
    next episode draws the same noise again."""
    rngs, timer, noise = jf.astate.rng, np.zeros(plan_crash.shape[1], int), []
    for e in range(n_eps):
        g, new = jax_episode_noise(rngs, CFG_J.n_steps, head_sizes(CFG_J))
        noise.append(np.asarray(g))
        was_down = timer > 0
        rngs = jnp.where(jnp.asarray(was_down)[:, None], rngs, new)
        timer = np.maximum(timer - 1, 0)
        timer = np.where(plan_crash[e] & (timer == 0), recovery, timer)
    return torch.tensor(np.stack(noise))


def replayed_byz_noise(seed, like, n_eps):
    """JAX's byzantine noise of each episode's round: ``fold_in(
    PRNGKey(seed), e)`` split per leaf, as the port's ``byz_noise``."""
    per = [jax_leaf_noise(jax.random.fold_in(jax.random.PRNGKey(seed), e),
                          like) for e in range(n_eps)]
    return {k: torch.tensor(np.stack([p[k] for p in per])) for k in per[0]}


CHAOS_A, CHAOS_EPS = 8, 8


@pytest.fixture(scope="module")
def chaos_fleets():
    key = jax.random.PRNGKey(1)
    return {name: jfleet.fleet_init(CFG_J, CHAOS_A, key, n_pods=P,
                                    env_backend=jb)
            for name, (jb, _) in BACKENDS.items()}


@pytest.mark.parametrize("backend,codec,mode,n_eps", [
    ("fluid", "int8", "sign_flip", CHAOS_EPS),
    ("twin", "int8", "sign_flip", CHAOS_EPS),
    ("fluid", "topk", "sign_flip", CHAOS_EPS),
    ("fluid", "int8", "noise", 2)])
def test_chaos_slice_matches_jax(chaos_fleets, backend, codec, mode, n_eps):
    """A=8, P=2, ``fl_every=1``, eight episodes (eight rounds, two merges)
    with stragglers, async rounds, the trimmed mean, the clip, crashes,
    byzantine uploads and partitions: the port's graph driver and reference
    driver against JAX's ``train_fleet_scan``. Counts in the history,
    actions (the buffers' and the env's), timers and the parked uploads'
    masks and staleness exact; values within the band. The two port
    drivers agree bit for bit. The ``noise`` mode (JAX's draws replayed)
    runs two episodes: from the third, the noise (scale 10) that the trim
    lets through at n <= 4 per pod has grown Adam's second moments to
    ~1e5, where the two packages' summation orders part by ~2x the band
    (an amplification of roundoff, the same in both algorithms)."""
    jb, tb = BACKENDS[backend]
    jf0 = chaos_fleets[backend]
    rng = np.random.default_rng(2)
    traces = rng.uniform(5.0, 160.0, (CHAOS_A, n_eps * CFG_J.n_steps)
                         ).astype(np.float32)
    kw = dict(straggler_prob=0.25, seed=3)
    cj, ct = chaos_config("jax", codec, mode), chaos_config("torch", codec,
                                                             mode)
    jf, hist_j = jfleet.train_fleet_scan(CFG_J, jf0, jnp.asarray(traces),
                                         env_backend=jb, **cj, **kw)
    plan = jfaults.draw_fault_plan(jfed.fl_schedule(CFG_J, n_eps),
                                   CHAOS_A, P, cj["faults"])
    assert plan.crash.any() and plan.byzantine.any()
    assert plan.partition.any() or n_eps < CFG_J.hierarchical_period
    gumbel = crash_replayed_noise(jf0, plan.crash, 2, n_eps)
    byz_noise = (replayed_byz_noise(0, jf0.astate.params, n_eps)
                 if mode == "noise" else None)
    runs = []
    for drive in (tfleet.train_fleet_scan, tfleet.train_fleet_reference):
        tf = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(jf0), device="cpu")
        tf, hist_t = drive(CFG_T, tf, torch.tensor(traces), env_backend=tb,
                           gumbel=gumbel, byz_noise=byz_noise, **ct, **kw)
        runs.append((hist_t, tfleet.fleet_to_numpy(tf)))
    (hist_t, got), (hist_r, got_r) = runs
    assert set(hist_t) == set(hist_r) == set(hist_j)
    for k, v in hist_r.items():
        np.testing.assert_array_equal(hist_t[k], v, err_msg=k)
    assert flat(got).keys() == flat(got_r).keys()
    for k, v in flat(got_r).items():
        np.testing.assert_array_equal(flat(got)[k], v, err_msg=k)
    for k in ("fl_missed", "fl_stale_used", "fl_rejected", "fl_clipped"):
        exact(hist_t[k], hist_j[k], k)
    for k, v in hist_t.items():
        close(v, hist_j[k], k)
    assert hist_j["fl_missed"].sum() > 0
    assert hist_j["fl_stale_used"].sum() > 0 or n_eps < CHAOS_EPS
    want = jax_fleet_tree(jf)
    for k in ("crash_timer", "partition_timer"):
        exact(got[k], want[k], k)
    exact(got["pending"]["has"], want["pending"]["has"], "pending.has")
    exact(got["pending"]["staleness"], want["pending"]["staleness"])
    exact(got["buffer"]["actions"], want["buffer"]["actions"], "actions")
    exact(got["env_state"]["cur_action"], want["env_state"]["cur_action"])
    if backend == "twin":
        for k, v in want["env_state"]["sim"].items():
            exact(got["env_state"]["sim"][k], v, f"sim.{k}")
    close_state(got, want, ("params", "opt", "base_params", "residuals",
                            "buffer", "env_state"), codec)
    close_decoded(got["pending"]["delta"], want["pending"]["delta"], codec,
                  "pending.")


@pytest.mark.parametrize("backend", ["fluid", "twin"])
@pytest.mark.parametrize("mode,agg", [("noise", "median"), ("nan", "mean")])
def test_scan_is_the_reference_under_chaos(traces, backend, mode, agg):
    """The port's two drivers under every fault, async rounds and a robust
    statistic (or the mean with NaN uploads), noise from the fleets' and
    the fault generator's seeds: bit for bit, NaN uploads rejected and the
    params finite."""
    tb = BACKENDS[backend][1]
    ct = chaos_config("torch", "int8", mode)
    ct["guards"] = tguards.GuardConfig(agg=agg, clip_factor=3.0)
    ct["faults"] = dataclasses.replace(ct["faults"], byzantine_frac=0.5)
    runs = []
    for drive in (tfleet.train_fleet_reference, tfleet.train_fleet_scan):
        fleet = tfleet.fleet_init(CFG_T, A, 5, n_pods=P, device="cpu",
                                  env_backend=tb)
        fleet, hist = drive(CFG_T, fleet, torch.tensor(traces),
                            straggler_prob=0.25, seed=3, env_backend=tb,
                            **ct)
        runs.append((hist, flat(tfleet.fleet_to_numpy(fleet))))
    (hist_r, state_r), (hist_s, state_s) = runs
    for k, v in hist_r.items():
        np.testing.assert_array_equal(hist_s[k], v, err_msg=k)
    for k, v in state_r.items():
        np.testing.assert_array_equal(state_s[k], v, err_msg=k)
    if mode == "nan":
        assert hist_s["fl_rejected"].sum() > 0
    for k, v in state_s.items():
        if k.startswith("params."):
            assert np.isfinite(v).all(), k


@pytest.mark.parametrize("chaos", [False, True], ids=["default", "chaos"])
def test_histories_carry_the_jax_keys(chaos):
    """Both of the port's drivers return exactly the history keys of JAX's
    ``train_fleet_scan`` for the same configuration (``FL_METRIC_KEYS``
    with ``fl_stale_used`` and ``fl_clipped``, zero when unused)."""
    a, n_eps = 4, 2
    traces = np.random.default_rng(1).uniform(
        5.0, 160.0, (a, n_eps * CFG_J.n_steps)).astype(np.float32)
    kj = chaos_config("jax") if chaos else {}
    kt = chaos_config("torch") if chaos else {}
    _, hist_j = jfleet.train_fleet_scan(
        CFG_J, jfleet.fleet_init(CFG_J, a, jax.random.PRNGKey(0), n_pods=P),
        jnp.asarray(traces), **kj)
    for drive in (tfleet.train_fleet_scan, tfleet.train_fleet_reference):
        fleet = tfleet.fleet_init(CFG_T, a, 0, n_pods=P, device="cpu")
        _, hist_t = drive(CFG_T, fleet, torch.tensor(traces), **kt)
        assert sorted(hist_t) == sorted(hist_j), drive.__name__
    assert set(FL_METRIC_KEYS) == set(jtr.FL_METRIC_KEYS)


# sha256 of the parent port's default runs (``default_run_digest``), taken
# on the tree before the chaos layer: the defaults must stay bit for bit
PARENT_DIGESTS = {
    ("fluid", "float32"):
        "aa2d6c73e059e2c1d292d2414db7ede9f0e36f659224fe2b8cb95b486a87d18b",
    ("fluid", "int8"):
        "c2758651e38ff79495fa7aa1b4a9ac2660fc5adc5423b9c221f6c479cfb00bcc",
    ("twin", "topk"):
        "5dfa40f046b987149a54e6daafc32afbc89247367c947b0da606012b1f4e85b9",
}
PARENT_FL_KEYS = ("fl_payload_bytes", "fl_uplink_s", "fl_missed",
                  "fl_rejected")


def default_run_digest(drive, backend, codec, **chaos):
    """sha256 of one default-config run at A=4, P=2, ``fl_every=1``, four
    episodes (stragglers 0.25, noise from the fleet's generator): the
    episode metrics and the parent's four FL metrics as float32, then
    every state leaf the parent's ``fleet_to_numpy`` had."""
    tb = BACKENDS[backend][1]
    traces = np.random.default_rng(0).uniform(5.0, 160.0, (4, 40)).astype(
        np.float32)
    fleet = tfleet.fleet_init(CFG_T, 4, 5, n_pods=2, device="cpu",
                              env_backend=tb)
    fleet, hist = drive(
        CFG_T, fleet, torch.tensor(traces), straggler_prob=0.25, seed=3,
        env_backend=tb, transport=ttr.TransportConfig(
            codec=codec, deadline_s=0.002 if codec == "int8" else 0.0),
        **chaos)
    h = hashlib.sha256()
    for k in (*EPISODE_METRICS, *PARENT_FL_KEYS):
        h.update(k.encode() + np.asarray(hist[k], np.float32).tobytes())

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", np.ascontiguousarray(v)
    for name, v in leaves(tfleet.fleet_to_numpy(fleet)):
        if not name.startswith(("pending.", "crash_timer",
                                "partition_timer")):
            h.update(name.encode() + v.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("backend,codec", list(PARENT_DIGESTS))
def test_default_config_is_the_parent_port_bit_for_bit(backend, codec):
    """The defaults (no guards, no faults, sync rounds) and the explicit
    default configs give the parent port's numbers bit for bit, under both
    drivers, as ``test_default_guards_are_identity`` holds the JAX
    package."""
    for drive in (tfleet.train_fleet_scan, tfleet.train_fleet_reference):
        assert default_run_digest(drive, backend, codec) == \
            PARENT_DIGESTS[backend, codec], drive.__name__
    assert default_run_digest(
        tfleet.train_fleet_scan, backend, codec, faults=tfaults.NO_FAULTS,
        guards=tguards.DEFAULT_GUARDS) == PARENT_DIGESTS[backend, codec]


CHAOS_ARGV = ["--fl-codec", "int8", "--fl-deadline-s", "0.002", "--fl-async",
              "--robust-agg", "trimmed", "--clip-factor", "3",
              "--fault-crash-prob", "0.1", "--fault-byzantine-frac", "0.25",
              "--fault-byzantine-mode", "sign_flip",
              "--fault-partition-prob", "0.3"]


@pytest.mark.parametrize("extra", [[], ["--env-backend", "twin"]],
                         ids=["fluid", "twin"])
def test_cli_chaos_flags_give_equal_histories(extra, capsys):
    """The slice's CLI path on the CPU under both drivers: equal
    histories, the async and chaos summary lines printed."""
    hists = []
    for driver in ("scan", "reference"):
        _, hist = train_cli.main(["--device", "cpu", "--agents", "8",
                                  "--episodes", "6", "--fl-every", "1",
                                  *CHAOS_ARGV, *extra, "--driver", driver])
        out = capsys.readouterr().out
        assert "async=True" in out and "chaos: crash_prob=0.1" in out
        assert "agg=trimmed, clip=3.0" in out
        hists.append(hist)
    for k, v in hists[1].items():
        np.testing.assert_array_equal(hists[0][k], v, err_msg=k)
    assert hists[0]["fl_stale_used"].sum() > 0
    assert hists[0]["fl_clipped"].sum() > 0


@pytest.mark.parametrize("argv,message", [
    (["--fl-async"], "--fl-async parks deadline-missed uploads"),
    (["--robust-agg", "mode"], "invalid choice: 'mode'"),
    (["--fault-byzantine-mode", "flip"], "invalid choice: 'flip'"),
])
def test_cli_flag_errors_match_jax(argv, message, capsys):
    """The new flags fail as the JAX CLI's do, with its messages."""
    from repro.launch import train_fleet as jax_cli
    errors = []
    for cli in (jax_cli, train_cli):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--episodes", "1", *argv])
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert message in errors[1]
    assert errors[0].split("error: ")[1] == errors[1].split("error: ")[1]


@pytest.mark.parametrize("argv,exc", [
    (["--trim-frac", "0.5"], ValueError),
    (["--fault-crash-prob", "1.5"], ValueError),
    (["--fault-crash-recovery", "0"], ValueError),
])
def test_cli_config_errors_match_jax(argv, exc):
    """Out-of-range values fail in ``GuardConfig`` / ``FaultConfig`` with
    the JAX package's message."""
    from repro.launch import train_fleet as jax_cli
    msgs = []
    for cli, extra in ((jax_cli, []), (train_cli, ["--device", "cpu"])):
        with pytest.raises(exc) as err:
            cli.main(["--episodes", "1", "--agents", "2", *extra, *argv])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_cli_has_no_suspicion_gate_yet(capsys):
    """``--susp-threshold`` needs the health observatory: without
    ``--health`` the port's CLI refuses it with the JAX CLI's message (the
    gate itself: ``tests/test_torch_health.py``)."""
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu", "--susp-threshold", "0.5"])
    assert "--susp-threshold gates selection on the suspicion EMA the " \
        "observatory maintains; add --health" in capsys.readouterr().err
