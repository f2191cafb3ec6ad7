"""The single-head ablation (Fig. 12, ``FCPOConfig(single_head=True)``) of
the port against the JAX package on the CPU: the agent's forward, joint
Gumbel-max draw and log-probs, the update, one FL round (Algorithm 1 over
the one head, Algorithm 2's fine-tune on it), both fleet drivers over four
episodes (fluid and twin, int8: a pod merge at the fourth round), the
state policies and checkpoints.

JAX's single head draws ``categorical(key, joint)`` on the step key itself,
so its noise is ``gumbel(key, (112,))``; the port replays it from the same
keys. Floats within rtol 1e-4 / atol 1e-5, actions, selections and twin
state exact; the port's two drivers bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import agent as jagent
from repro.core import fleet as jfleet
from repro.core import ppo as jppo
from repro.core.backends import FLUID
from repro.core.backends import TwinBackend as JTwin
from repro.fl import transport as jtr
from repro.resilience.guards import DEFAULT_GUARDS
from repro.sim.state import SimParams as JSimParams
from repro.training import checkpoint as jckpt
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import agent as tagent
from repro_torch.core import fleet as tfleet
from repro_torch.core import ppo as tppo
from repro_torch.core.backends import TwinBackend
from repro_torch.fl import codec as tcodec
from repro_torch.fl import transport as ttr
from repro_torch.sim.state import SimParams
from repro_torch.training import checkpoint as ckpt
from test_torch_state_dtype import bits, exact_tree
from test_torch_support import (_flat, close, close_state, exact,
                                jax_agents, jax_fleet_tree, jax_joint_noise,
                                np_tree, to_rollout)

A, P, N_EPS = 4, 2, 4
CFG_J = JCfg(single_head=True, fl_every=1)
CFG_T = TCfg(single_head=True, fl_every=1)
JOINT = 4 * 7 * 4
BACKENDS = {"fluid": (None, None),
            "twin": (JTwin(sp=JSimParams()), TwinBackend(sp=SimParams()))}
INT8 = dict(codec="int8", deadline_s=0.002)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def episode_noise(jf, n_eps=N_EPS):
    """(n_eps, A, n_steps, 112) noise of ``n_eps`` episodes of ``jf``."""
    rngs, out = jf.astate.rng, []
    for _ in range(n_eps):
        g, rngs = jax_joint_noise(rngs, CFG_J.n_steps, JOINT)
        out.append(np.asarray(g))
    return torch.tensor(np.stack(out))


def masks(rng, a=A):
    m = rng.random((a, 15)) < 0.7
    m[:, [0, 4, 11]] = True                      # one valid option per head
    parts = (slice(0, 4), slice(4, 11), slice(11, 15))
    return (jagent.ActionMask(*(jnp.asarray(m[:, s]) for s in parts)),
            tagent.ActionMask(*(torch.as_tensor(m[:, s]) for s in parts)))


@pytest.fixture(scope="module")
def jax_fleets():
    key = jax.random.PRNGKey(0)
    return {name: jfleet.fleet_init(CFG_J, A, key, n_pods=P, env_backend=jb)
            for name, (jb, _) in BACKENDS.items()}


def test_single_head_policy_layout():
    """One joint head under JAX's name, no ``head_bs`` / ``head_mt``; the
    noise of one draw is the joint's width (56 at n_mt=2)."""
    pol = tagent.agent_init(CFG_T, 3, torch.Generator().manual_seed(0),
                            "cpu")
    shapes = {k: tuple(v.shape) for k, v in pol.params().items()}
    jshapes = {".".join(p.key for p in path): (3,) + tuple(x.shape)
               for path, x in jax.tree_util.tree_flatten_with_path(
                   jagent.agent_init(CFG_J, jax.random.PRNGKey(0)))[0]}
    assert shapes == jshapes
    assert shapes["head_res.w"] == (3, 48, JOINT)
    assert tagent.noise_width(CFG_T) == JOINT
    assert tagent.noise_width(TCfg(single_head=True, n_mt=2)) == 56
    assert tagent.noise_width(TCfg()) == 15


def test_joint_categorical_is_gumbel_argmax_on_the_step_key():
    """``categorical(k, joint) == argmax(gumbel(k, (112,)) + joint)``: the
    replayed noise picks JAX's joint actions."""
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(4), 5)
    noise, _ = jax_joint_noise(keys, 1, JOINT)
    logits = rng.normal(size=(5, JOINT)).astype(np.float32)
    for i in range(5):
        _, krng = jax.random.split(keys[i])
        want = int(jax.random.categorical(krng, jnp.asarray(logits[i])))
        assert want == int(np.argmax(np.asarray(noise[i, 0]) + logits[i]))


def test_single_head_forward_sample_and_logp_match_jax():
    """The marginals, the joint log-probs and the value under random
    masks; a joint draw on JAX's noise (decoded actions exact, logp in the
    band); ``action_logp`` of those actions."""
    rng = np.random.default_rng(1)
    params = jax_agents(CFG_J, A, jax.random.PRNGKey(1))
    tp = tagent.tensors_from_numpy(np_tree(params), "cpu")
    jm, tm = masks(rng)
    states = rng.normal(size=(A, 8)).astype(np.float32)
    out_j = jax.jit(jax.vmap(lambda p, s, m: jagent.agent_forward(
        CFG_J, p, s, m)))(params, jnp.asarray(states), jm)
    out_t = tagent.agent_forward(CFG_T, tp, torch.as_tensor(states), tm)
    assert set(out_t) == set(out_j) == {"res", "bs", "mt", "joint", "value"}
    for k in out_j:
        close(out_t[k], out_j[k], k)
    keys = jax.random.split(jax.random.PRNGKey(9), A)
    act_j, logp_j, _ = jax.jit(jax.vmap(
        lambda p, s, m, k: jagent.sample_actions(CFG_J, p, s, m, k)))(
        params, jnp.asarray(states), jm, keys)
    g = np.stack([np.asarray(jax.random.gumbel(k, (JOINT,))) for k in keys])
    act_t, logp_t, _ = tagent.sample_actions(CFG_T, tp,
                                             torch.as_tensor(states), tm,
                                             gumbel=torch.tensor(g))
    exact(act_t, act_j)
    close(logp_t, logp_j)
    # every drawn action is allowed by its agent's masks
    for h, m in enumerate((tm.res, tm.bs, tm.mt)):
        assert m[torch.arange(A), act_t[:, h]].all()
    lp_j, v_j, pr_j = jax.jit(jax.vmap(lambda p, s, a, m: jagent.action_logp(
        CFG_J, p, s, a, m)))(params, jnp.asarray(states), act_j, jm)
    lp_t, v_t, pr_t = tagent.action_logp(CFG_T, tp, torch.as_tensor(states),
                                         act_t, tm)
    close(lp_t, lp_j, "logp")
    close(v_t, v_j, "value")
    close(pr_t, pr_j, "probs")
    close(lp_t, logp_t, "sample vs action_logp")


def test_single_head_agent_update_matches_jax():
    """Two chained loss-gated updates of the single head (``ppo`` mode,
    gate off): params, Adam moments, step counters and losses."""
    cfg_j = JCfg(single_head=True, policy_mode="ppo", loss_gate=0.0)
    cfg_t = TCfg(single_head=True, policy_mode="ppo", loss_gate=0.0)
    rng = np.random.default_rng(2)
    params = jax_agents(cfg_j, A, jax.random.PRNGKey(2))
    jm, tm = masks(rng)
    opt_j = jax.vmap(jppo.agent_opt_init)(params)
    upd = jax.jit(jax.vmap(lambda p, o, r, m: jppo.agent_update(
        cfg_j, p, o, r, m)))
    for _ in range(2):
        r = dict(states=rng.normal(size=(A, 10, 8)).astype(np.float32),
                 actions=np.stack([np.zeros((A, 10)), np.full((A, 10), 4),
                                   np.zeros((A, 10))], -1).astype(np.int32),
                 logp_old=-np.abs(rng.normal(size=(A, 10))).astype(
                     np.float32) - 1,
                 rewards=np.tanh(rng.normal(size=(A, 10))).astype(np.float32),
                 values_old=(0.1 * rng.normal(size=(A, 10))).astype(
                     np.float32))
        rj = jppo.Rollout(**{k: jnp.asarray(v) for k, v in r.items()})
        rt = to_rollout(rj)
        opt_t = {"m": tagent.tensors_from_numpy(np_tree(opt_j["m"]), "cpu"),
                 "v": tagent.tensors_from_numpy(np_tree(opt_j["v"]), "cpu"),
                 "t": torch.tensor(np.asarray(opt_j["t"]))}
        leaves = {k: v.requires_grad_(True) for k, v in
                  tagent.tensors_from_numpy(np_tree(params), "cpu").items()}
        params, opt_j, met_j = upd(params, opt_j, rj, jm)
        new_t, opt_t, met_t = tppo.agent_update(cfg_t, leaves, opt_t, rt, tm)
        pj = tagent.tensors_from_numpy(np_tree(params), "cpu")
        mj = tagent.tensors_from_numpy(np_tree(opt_j["m"]), "cpu")
        for k in new_t:
            close(new_t[k], pj[k], f"param {k}")
            close(opt_t["m"][k], mj[k], f"m {k}")
        exact(opt_t["t"], opt_j["t"])
        close(met_t["loss"], met_j["loss"], "loss")
    assert (np.asarray(opt_j["t"]) == 2).all()


@pytest.mark.parametrize("codec", ["float32", "int8"])
def test_single_head_fl_round_matches_jax(jax_fleets, codec):
    """One episode, then one round with a straggler: Algorithm 1 skips the
    absent heads, groups the joint head by the resolution masks, and
    Algorithm 2 fine-tunes it; int8 sends the 8 leaves in one codec call
    (a deadline drops slow links)."""
    jf0 = jax_fleets["fluid"]
    rates = jnp.asarray(np.random.default_rng(3).uniform(5, 150, (A, 10)),
                        jnp.float32)
    jf, roll_j, _ = jfleet.fleet_episode(CFG_J, jf0, rates, learn=True,
                                         backend=FLUID, health=None)
    avail = np.array([1, 0, 1, 1], bool)
    tf = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(jf), device="cpu")
    transport = INT8 if codec == "int8" else dict(codec="float32")
    jf2, sel_j, met_j = jfleet.fl_round(
        CFG_J, jf, roll_j, jnp.asarray(avail),
        transport=jtr.TransportConfig(**transport), guards=DEFAULT_GUARDS,
        faults=None, byzantine=None, fault_key=None, health=None)
    calls = []
    leaves_fn = tcodec.delta_codec_leaves

    def counting(xs, *args, **kw):
        calls.append(len(xs))
        return leaves_fn(xs, *args, **kw)
    tcodec.delta_codec_leaves = counting
    try:
        tf2, sel_t, met_t = tfleet.fl_round(
            CFG_T, tf, to_rollout(roll_j), torch.tensor(avail),
            transport=ttr.TransportConfig(**transport))
    finally:
        tcodec.delta_codec_leaves = leaves_fn
    # one codec call for the single head's 8 leaves (the cascade has 12)
    assert calls == ([8] if codec == "int8" else [])
    exact(sel_t, sel_j)
    for k, v in met_t.items():
        close(v, met_j[k], k)
    close_state(tfleet.fleet_to_numpy(tf2), jax_fleet_tree(jf2),
                ("params", "opt", "base_params", "residuals", "buffer"),
                codec)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_single_head_drivers_match_jax(jax_fleets, backend):
    """Both drivers over four episodes (int8 with a deadline, stragglers,
    a pod merge at the fourth round): the port's graph driver against
    JAX's ``train_fleet_scan`` (histories, final state; the twin state
    exact), and the port's reference driver against its graph driver bit
    for bit."""
    jb, tb = BACKENDS[backend]
    jf0 = jax_fleets[backend]
    traces = np.random.default_rng(4).uniform(
        5.0, 160.0, (A, N_EPS * CFG_J.n_steps)).astype(np.float32)
    kw = dict(straggler_prob=0.25, seed=3)
    jf, hist_j = jfleet.train_fleet_scan(
        CFG_J, jf0, jnp.asarray(traces), env_backend=jb,
        transport=jtr.TransportConfig(**INT8), **kw)
    noise = episode_noise(jf0)
    runs = []
    for drive in (tfleet.train_fleet_scan, tfleet.train_fleet_reference):
        tf = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(jf0),
                                     device="cpu")
        runs.append(drive(CFG_T, tf, torch.tensor(traces), env_backend=tb,
                          transport=ttr.TransportConfig(**INT8),
                          gumbel=noise, **kw))
    (tf, hist_t), (tf_r, hist_r) = runs
    assert set(hist_t) <= set(hist_j)
    for k, v in hist_t.items():
        close(v, hist_j[k], k)
        np.testing.assert_array_equal(v, hist_r[k], err_msg=k)
    assert (hist_t["fl_payload_bytes"] > 0).all()
    got, want = tfleet.fleet_to_numpy(tf), jax_fleet_tree(jf)
    if backend == "twin":
        for k, v in want["env_state"]["sim"].items():
            exact(got["env_state"]["sim"][k], v, f"sim.{k}")
    close_state(got, want, ("params", "opt", "base_params", "residuals",
                            "buffer"), "int8")
    for (name, a), (_, b) in zip(sorted(_flat(got).items()),
                                 sorted(_flat(tfleet.fleet_to_numpy(
                                     tf_r)).items())):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)


@pytest.mark.parametrize("policy", ["float32", "lean"])
def test_single_head_state_policy_and_checkpoints(jax_fleets, tmp_path,
                                                  policy):
    """A single-head fleet cast to a state policy equals JAX's cast leaf
    for leaf; its checkpoint passes between the packages both ways (equal
    key sets, every leaf's dtype and bits); a trained port fleet
    round-trips exactly."""
    jf = jfleet.fleet_cast(jax_fleets["fluid"], policy)
    tf = tfleet.fleet_cast(tfleet.fleet_from_numpy(
        CFG_T, jax_fleet_tree(jax_fleets["fluid"]), device="cpu"), policy)
    exact_tree(tfleet.fleet_to_numpy(tf), jax_fleet_tree(jf))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jckpt.save(str(jdir), 1, jf)
    back, _ = ckpt.restore(str(jdir), 1, tf, CFG_T)
    exact_tree(tfleet.fleet_to_numpy(back), jax_fleet_tree(jf))
    ckpt.save(str(tdir), 1, back)
    jback, _ = jckpt.restore(str(tdir), 1, jf)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jf)[0],
                            jax.tree.leaves(jback)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=str(path))
    trained, _ = tfleet.train_fleet_scan(
        CFG_T, back, torch.tensor(np.full((A, 20), 40.0, np.float32)),
        transport=ttr.TransportConfig(codec="int8"))
    ckpt.save(str(tdir), 2, trained)
    again, _ = ckpt.restore(str(tdir), 2, tf, CFG_T)
    for (name, a), (_, b) in zip(
            sorted(_flat(tfleet.fleet_to_numpy(again)).items()),
            sorted(_flat(tfleet.fleet_to_numpy(trained)).items())):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=name)
    assert "0/.params/head_res/w" in ckpt.fleet_flat(trained)
    assert not any("head_bs" in k for k in ckpt.fleet_flat(trained)
                   if "params" in k or k.startswith(("1/", "9/", "10/")))
