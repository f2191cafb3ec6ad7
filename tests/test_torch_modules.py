"""The port's env, agent and PPO modules against the JAX package on the CPU.

Same inputs (numpy, from a seed) through ``repro.core.{env,agent,ppo}``
and ``repro_torch.core.{env,agent,ppo}``. Float values within rtol 1e-4 /
atol 1e-5; actions, gate decisions and step counters exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import env as jenv
from repro.core import ppo as jppo
from repro.core.agent import ActionMask as JMask
from repro.core.agent import agent_forward as j_forward
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import env as tenv
from repro_torch.core import ppo as tppo
from repro_torch.core.agent import ActionMask, agent_forward, \
    tensors_from_numpy
from test_torch_support import close, exact, jax_agents, np_tree

A, T = 5, 10


def j_params(cfg, a, seed):
    return jax_agents(cfg, a, jax.random.PRNGKey(seed))


def masks_np(rng, a):
    m = rng.random((a, 15)) < 0.7
    m[:, [0, 4, 11]] = True
    return m


def both_masks(m):
    parts = (slice(0, 4), slice(4, 11), slice(11, 15))
    return (JMask(*(jnp.asarray(m[:, s]) for s in parts)),
            ActionMask(*(torch.as_tensor(m[:, s]) for s in parts)))


def valid_actions(rng, m, shape):
    """Random actions allowed by the per-agent masks, (A, T, 3)."""
    out = np.zeros(shape + (3,), np.int32)
    for a in range(shape[0]):
        for h, s in enumerate((slice(0, 4), slice(4, 11), slice(11, 15))):
            ok = np.flatnonzero(m[a, s])
            out[a, :, h] = rng.choice(ok, shape[1])
    return out


def rollout_np(rng, m, nan_agent=None):
    r = dict(states=rng.normal(size=(A, T, 8)).astype(np.float32),
             actions=valid_actions(rng, m, (A, T)),
             logp_old=-np.abs(rng.normal(size=(A, T))).astype(np.float32) - 1,
             rewards=np.tanh(rng.normal(size=(A, T))).astype(np.float32),
             values_old=(0.1 * rng.normal(size=(A, T))).astype(np.float32))
    if nan_agent is not None:
        r["rewards"][nan_agent, 3] = np.nan
    return (jppo.Rollout(**{k: jnp.asarray(v) for k, v in r.items()}),
            tppo.Rollout(**{k: torch.as_tensor(v) for k, v in r.items()}))


# ---------------------------------------------------------------------------
# env
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
def test_env_steps_match_jax(seed):
    """Ten chained control intervals at rates up to 400 (queue overflow and
    drops included): state, reward and info per step."""
    cfg = JCfg()
    rng = np.random.default_rng(seed)
    speeds = rng.choice([0.5, 0.75, 1.0, 2.0], A).astype(np.float32)
    ep_j = jax.vmap(lambda s: jenv.default_env_params(s, 0.25))(
        jnp.asarray(speeds))
    ep_t = tenv.default_env_params(torch.as_tensor(speeds), 0.25, "cpu")
    for f in ep_j._fields:
        close(getattr(ep_t, f), getattr(ep_j, f), f)
    s_j = jax.vmap(lambda _: jenv.env_init(cfg))(jnp.arange(A))
    s_t = tenv.env_init(TCfg(), A, "cpu")
    step_j = jax.jit(jax.vmap(lambda e, s, a, r: jenv.env_step(cfg, e, s, a,
                                                               r)))
    obs_j = jax.jit(jax.vmap(lambda e, s, r: jenv.observe(cfg, e, s, r)))
    for t in range(10):
        act = np.stack([rng.integers(0, 4, A), rng.integers(0, 7, A),
                        rng.integers(0, 4, A)], -1).astype(np.int32)
        rate = rng.uniform(1.0, 400.0, A).astype(np.float32)
        close(tenv.observe(TCfg(), ep_t, s_t, torch.as_tensor(rate)),
              obs_j(ep_j, s_j, jnp.asarray(rate)), f"obs t={t}")
        s_j, r_j, i_j = step_j(ep_j, s_j, jnp.asarray(act), jnp.asarray(rate))
        s_t, r_t, i_t = tenv.env_step(TCfg(), ep_t, s_t,
                                      torch.as_tensor(act).long(),
                                      torch.as_tensor(rate))
        close(r_t, r_j, f"reward t={t}")
        for k in i_j:
            close(i_t[k], i_j[k], f"{k} t={t}")
        for f in ("pre_q", "post_q", "drops", "ema_lat"):
            close(getattr(s_t, f), getattr(s_j, f), f"{f} t={t}")
        exact(s_t.cur_action, s_j.cur_action)
        exact(s_t.t, s_j.t)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    from repro_torch.core.fleet import fleet_init
    from repro_torch.launch import train_fleet
    with pytest.raises(RuntimeError, match="CUDA"):
        tenv.env_init(TCfg(), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet_init(TCfg(), 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_fleet.main(["--episodes", "1"])
    # the health layer's constructors, and the flight recorder's entry
    # points: the CLIs' --trace-out / --attribution and the profile layer
    from repro_torch.health import HealthConfig, health_init
    from repro_torch.health.drift import drift_init
    from repro_torch.health.sketch import hist_init, p2_init
    from repro_torch.launch import simulate
    from repro_torch.obs.profile import fleet_memory_report
    for call in (lambda: health_init(HealthConfig(), 2, 15),
                 lambda: hist_init(16, (2,)), lambda: p2_init(0.5, (2,)),
                 lambda: drift_init((2,)),
                 lambda: train_fleet.main(["--episodes", "1", "--trace-out",
                                           "unused.json"]),
                 lambda: simulate.main(["--intervals", "2",
                                        "--attribution"]),
                 lambda: fleet_memory_report(TCfg(), 2, n_pods=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the comparison set: the baselines and the single-head fleet
    from repro_torch.core import baselines
    from repro_torch.core.agent import full_mask
    rates = np.full((8, 10), 30.0, np.float32)
    for call in (lambda: baselines.bcedge_masks(baselines.bcedge_config(), 2),
                 lambda: baselines.run_bcedge(8, rates, offline_episodes=1),
                 lambda: baselines.run_octopinf(8, rates),
                 lambda: baselines.run_distream(8, rates),
                 lambda: fleet_init(TCfg(single_head=True), 2),
                 lambda: full_mask(TCfg(), 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the fleet mesh: the CLI's --mesh and the mesh builders (NCCL on the
    # card by default)
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_mod
    for call in (lambda: train_fleet.main(["--episodes", "1", "--mesh",
                                           "fleet"]),
                 lambda: mesh_mod.make_fleet_mesh(),
                 lambda: mesh_mod.make_debug_mesh(),
                 lambda: mesh_mod.init_world()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# agent
# ---------------------------------------------------------------------------
def test_agent_forward_matches_jax_with_masks():
    cfg = JCfg()
    rng = np.random.default_rng(2)
    params = j_params(cfg, A, 2)
    m = masks_np(rng, A)
    jm, tm = both_masks(m)
    states = rng.normal(size=(A, T, 8)).astype(np.float32)
    out_j = jax.jit(jax.vmap(lambda p, s, mm: j_forward(cfg, p, s, mm)))(
        params, jnp.asarray(states), jm)
    out_t = agent_forward(TCfg(), tensors_from_numpy(np_tree(params), "cpu"),
                          torch.as_tensor(states), tm)
    for k in out_j:
        close(out_t[k], out_j[k], k)


# ---------------------------------------------------------------------------
# PPO: losses, gradients, update, fine-tune
# ---------------------------------------------------------------------------
def leaves(params):
    return {k: v.clone().requires_grad_(True) for k, v in
            tensors_from_numpy(np_tree(params), "cpu").items()}


def flat_j(tree):
    from repro_torch.core.agent import _flatten
    return _flatten(np_tree(tree))


@pytest.mark.parametrize("mode", ["fcpo", "ppo"])
def test_fcpo_loss_and_gradients_match_jax(mode):
    """Per-agent losses and their parts, and autograd over the summed
    losses against per-agent jax.grad (the gradients separate)."""
    cfg_j, cfg_t = JCfg(policy_mode=mode), TCfg(policy_mode=mode)
    rng = np.random.default_rng(3)
    params = j_params(cfg_j, A, 3)
    jm, tm = both_masks(masks_np(rng, A))
    rj, rt = rollout_np(rng, np.ones((A, 15), bool))
    (loss_j, parts_j), grads_j = jax.jit(jax.vmap(
        lambda p, r, mm: jax.value_and_grad(
            lambda q: jppo.fcpo_loss(cfg_j, q, r, mm), has_aux=True)(p)))(
        params, rj, jm)
    p = leaves(params)
    loss_t, parts_t = tppo.fcpo_loss(cfg_t, p, rt, tm)
    grads_t = torch.autograd.grad(loss_t.sum(), list(p.values()))
    close(loss_t, loss_j, "loss")
    for k in parts_j:
        close(parts_t[k], parts_j[k], k)
    gj = flat_j(grads_j)
    for (k, _), g in zip(p.items(), grads_t):
        close(g, gj[k], f"grad {k}")


def test_advantage_normalisation_uses_population_std():
    """``jnp.std`` is the population std; torch's default is not."""
    rng = np.random.default_rng(4)
    rew = np.tanh(rng.normal(size=(3, T))).astype(np.float32)
    val = (0.1 * rng.normal(size=(3, T))).astype(np.float32)
    roll = tppo.Rollout(states=None, actions=None, logp_old=None,
                        rewards=torch.as_tensor(rew),
                        values_old=torch.as_tensor(val))
    adv_j = np.asarray(jax.jit(jax.vmap(
        lambda r, v: jppo.gae(JCfg(), r, v)))(rew, val))
    want = (adv_j - adv_j.mean(-1, keepdims=True)) / \
        (adv_j.std(-1, ddof=0, keepdims=True) + 1e-6)
    close(tppo._normalized_adv(TCfg(), roll), want)
    close(tppo.returns(TCfg(), torch.as_tensor(rew)),
          jax.jit(jax.vmap(lambda r: jppo.returns(JCfg(), r)))(rew))


@functools.lru_cache(maxsize=None)
def j_update(cfg_j):
    return jax.jit(jax.vmap(
        lambda p, o, r, mm: jppo.agent_update(cfg_j, p, o, r, mm)))


def run_update_both(cfg_j, cfg_t, params, opt_j, rj, rt, jm, tm):
    new_j, opt_j2, met_j = j_update(cfg_j)(params, opt_j, rj, jm)
    opt_t = {"m": tensors_from_numpy(np_tree(opt_j["m"]), "cpu"),
             "v": tensors_from_numpy(np_tree(opt_j["v"]), "cpu"),
             "t": torch.tensor(np.asarray(opt_j["t"]))}
    new_t, opt_t2, met_t = tppo.agent_update(cfg_t, leaves(params), opt_t,
                                             rt, tm)
    return (new_j, opt_j2, met_j), (new_t, opt_t2, met_t)


def assert_update_matches(j, t):
    (new_j, opt_j, met_j), (new_t, opt_t, met_t) = j, t
    pj, mj, vj = flat_j(new_j), flat_j(opt_j["m"]), flat_j(opt_j["v"])
    for k in new_t:
        close(new_t[k], pj[k], f"param {k}")
        close(opt_t["m"][k], mj[k], f"m {k}")
        close(opt_t["v"][k], vj[k], f"v {k}")
    exact(opt_t["t"], opt_j["t"])
    for k in ("gated", "update_rejected"):
        exact(met_t[k], met_j[k], k)
    close(met_t["loss"], met_j["loss"], "loss")


@pytest.mark.parametrize("case", ["updated", "gated", "nonfinite", "mixed"])
def test_agent_update_matches_jax(case):
    """The per-agent gate: updated agents advance ``t`` and move; gated
    agents keep params and the whole optimizer state; an agent whose loss
    is NaN keeps both (``update_rejected``). Two chained updates, so the
    second starts from non-zero moments."""
    gate = {"updated": 0.0, "gated": 1e9, "nonfinite": 0.0,
            "mixed": 0.5}[case]
    cfg_j, cfg_t = JCfg(loss_gate=gate), TCfg(loss_gate=gate)
    rng = np.random.default_rng(5)
    params = j_params(cfg_j, A, 5)
    jm, tm = both_masks(masks_np(rng, A))
    opt_j = jax.vmap(jppo.agent_opt_init)(params)
    for step in range(2):
        rj, rt = rollout_np(rng, np.ones((A, 15), bool),
                            nan_agent=1 if case == "nonfinite" else None)
        j, t = run_update_both(cfg_j, cfg_t, params, opt_j, rj, rt, jm, tm)
        assert_update_matches(j, t)
        params, opt_j = j[0], j[1]
    gated = np.asarray(j[2]["gated"])
    rejected = np.asarray(j[2]["update_rejected"])
    if case == "gated":
        assert gated.all() and int(np.asarray(opt_j["t"]).max()) == 0
    if case == "updated":
        assert not gated.any() and (np.asarray(opt_j["t"]) == 2).all()
    if case == "nonfinite":
        assert rejected[1] == 1 and rejected.sum() == 1
        assert int(np.asarray(opt_j["t"])[1]) == 0


def test_finetune_heads_matches_jax_and_frozen_leaves_keep_moments():
    """Alg. 2 fine-tune: heads move, backbone/value keep their params but
    their Adam moments still update (the frozen-leaf ``where``)."""
    cfg = JCfg()
    rng = np.random.default_rng(6)
    params = j_params(cfg, A, 6)
    jm, tm = both_masks(masks_np(rng, A))
    rj, rt = rollout_np(rng, np.ones((A, 15), bool))
    opt_j = jax.vmap(jppo.agent_opt_init)(params)
    new_j, opt_j2 = jax.jit(jax.vmap(
        lambda p, o, r, mm: jppo.finetune_heads(cfg, p, o, r, mm)))(
        params, opt_j, rj, jm)
    p0 = tensors_from_numpy(np_tree(params), "cpu")
    opt_t = {"m": {k: torch.zeros_like(v) for k, v in p0.items()},
             "v": {k: torch.zeros_like(v) for k, v in p0.items()},
             "t": torch.zeros(A, dtype=torch.int32)}
    new_t, opt_t2 = tppo.finetune_heads(TCfg(), p0, opt_t, rt, tm)
    pj, mj, vj = flat_j(new_j), flat_j(opt_j2["m"]), flat_j(opt_j2["v"])
    for k in new_t:
        close(new_t[k], pj[k], f"param {k}")
        close(opt_t2["m"][k], mj[k], f"m {k}")
        close(opt_t2["v"][k], vj[k], f"v {k}")
        frozen = k.split(".")[0] in ("backbone", "value")
        assert torch.equal(new_t[k], p0[k]) == frozen, k
        if k.startswith("backbone"):
            assert float(opt_t2["v"][k].abs().max()) > 0, k
    exact(opt_t2["t"], opt_j2["t"])
