"""Shared parity helpers for the PyTorch port's tests (``repro_torch``
against the JAX package ``repro``), and the tests of the helpers
themselves: the Gumbel replay of JAX's action draws and the numpy state
carry-over between the two packages.

Tolerances: float values rtol 1e-4 / atol 1e-5 (the repo's float32 band,
tests/test_golden.py); integer state and discrete decisions exact.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core.agent import ActionMask as JMask
from repro.core.agent import agent_init as j_agent_init
from repro.core.agent import sample_actions as j_sample_actions
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core.ppo import Rollout

RTOL, ATOL = 1e-4, 1e-5
NEAR_TIE = 1e-5


def np_tree(x):
    return jax.tree.map(np.asarray, x)


@partial(jax.jit, static_argnums=(0, 1))
def jax_agents(cfg, a, key):
    """A stacked JAX fleet's params: ``a`` agents from ``key`` (jitted: an
    eager ``vmap`` of ``agent_init`` costs seconds in dispatch)."""
    return jax.vmap(lambda k: j_agent_init(cfg, k))(jax.random.split(key, a))


def env_state_tree(es):
    """A JAX env state (the fluid ``EnvState`` or the twin's
    ``TwinEnvState``, whose ``sim`` nests a ``SimState``) as numpy dicts."""
    tree = es._asdict()
    if "sim" in tree:
        tree["sim"] = tree["sim"]._asdict()
    return np_tree(tree)


def jax_fleet_tree(jf):
    """The JAX fleet's state as the nested numpy dicts
    ``repro_torch.core.fleet.fleet_from_numpy`` reads."""
    a = jf.astate
    return {
        "params": np_tree(a.params),
        "opt": {"m": np_tree(a.opt["m"]), "v": np_tree(a.opt["v"]),
                "t": np.asarray(a.opt["t"])},
        "buffer": np_tree(a.buffer._asdict()),
        "env_state": env_state_tree(a.env_state),
        "env_params": np_tree(jf.env_params._asdict()),
        "base_params": np_tree(jf.base_params),
        "masks": np_tree(jf.masks._asdict()),
        "speeds": np.asarray(jf.speeds),
        "bandwidth": np.asarray(jf.bandwidth),
        "residuals": np_tree(jf.residuals),
        "pending": {"delta": np_tree(jf.pending.delta),
                    "staleness": np.asarray(jf.pending.staleness),
                    "has": np.asarray(jf.pending.has)},
        "crash_timer": np.asarray(jf.crash_timer),
        "partition_timer": np.asarray(jf.partition_timer),
    }


def to_rollout(jr):
    """A JAX (vmapped) Rollout as the port's Rollout on the CPU."""
    t = lambda x: torch.tensor(np.asarray(x))
    return Rollout(states=t(jr.states), actions=t(jr.actions).long(),
                   logp_old=t(jr.logp_old), rewards=t(jr.rewards),
                   values_old=t(jr.values_old))


def close(port, ref, msg="", rtol=RTOL, atol=ATOL):
    p = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(np.asarray(p, np.float64),
                               np.asarray(ref, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def exact(port, ref, msg=""):
    p = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    np.testing.assert_array_equal(np.asarray(p), np.asarray(ref),
                                  err_msg=msg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def close_state(got, want, keys, codec):
    """Final fleet state (``fleet_to_numpy`` / ``jax_fleet_tree``) within
    the band. int8 residuals: a coordinate whose ``frac = x/scale`` sits at
    a rounding tie may round the other way after float32 roundoff upstream
    — accepted for at most two coordinates per leaf, each off by no more
    than one quantization step (``scale >= 2·max|residual|`` of its
    row)."""
    for key in keys:
        if key == "residuals" and codec == "int8":
            for name, w in _flat(want[key]).items():
                g = _flat(got[key])[name]
                bad = ~np.isclose(g, w, rtol=1e-4, atol=1e-5)
                step = 2 * np.abs(w).reshape(len(w), -1).max(1)
                step = step.reshape((-1,) + (1,) * (w.ndim - 1))
                within = np.abs(g - w) <= 1.01 * np.broadcast_to(step, w.shape)
                assert bad.sum() <= 2 and within[bad].all(), \
                    f"residuals.{name}: {bad.sum()} coordinates off"
            continue
        close_tree(got[key], want[key], key + ".")


def close_decoded(got: dict, want: dict, codec, prefix=""):
    """Decoded deltas ({name: (A, ...)}, e.g. parked uploads) within the
    band. int8: a rounding tie upstream may move a coordinate by one
    quantization step (``max|row| / 127``) — accepted for at most two
    coordinates per leaf, as ``close_state`` accepts for residuals."""
    if codec != "int8":
        close_tree(got, want, prefix)
        return
    for name, w in _flat(want).items():
        g = _flat(got)[name]
        bad = ~np.isclose(g, w, rtol=1e-4, atol=1e-5)
        step = np.abs(w).reshape(len(w), -1).max(1) / 127
        step = step.reshape((-1,) + (1,) * (w.ndim - 1))
        within = np.abs(g - w) <= 1.01 * np.broadcast_to(step, w.shape)
        assert bad.sum() <= 2 and within[bad].all(), \
            f"{prefix}{name}: {bad.sum()} coordinates off"


def close_tree(port: dict, ref: dict, prefix=""):
    """Nested numpy dicts (``fleet_to_numpy`` / ``jax_fleet_tree``):
    floats within the band, integers and booleans exact."""
    for k, v in ref.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            close_tree(port[k], v, name + ".")
        elif np.issubdtype(np.asarray(v).dtype, np.floating):
            close(port[k], v, name)
        else:
            exact(port[k], v, name)


@partial(jax.jit, static_argnums=(1, 2))
def jax_episode_noise(rngs, n_steps, sizes):
    """The Gumbel noise JAX's ``run_episode`` draws, rebuilt from the
    fleet's (A, 2) keys: ``rng, krng = split(rng)`` per step, then
    ``split(krng, 3)`` per head and ``jax.random.gumbel``. Returns
    ((A, n_steps, sum(sizes)) noise, the advanced keys)."""
    def one(rng):
        def step(rng, _):
            rng, krng = jax.random.split(rng)
            ks = jax.random.split(krng, 3)
            g = jnp.concatenate([jax.random.gumbel(ks[i], (n,))
                                 for i, n in enumerate(sizes)])
            return rng, g
        rng, gs = jax.lax.scan(step, rng, None, length=n_steps)
        return gs, rng
    return jax.vmap(one)(rngs)


@partial(jax.jit, static_argnums=(1, 2))
def jax_joint_noise(rngs, n_steps, width):
    """The Gumbel noise JAX's ``run_episode`` draws for the single joint
    head (``FCPOConfig(single_head=True)``) from the fleet's (A, 2) keys:
    ``rng, krng = split(rng)`` per step, then ``gumbel(krng, (width,))``
    (the categorical's own draw on the step key). Returns ((A, n_steps,
    width) noise, the advanced keys)."""
    def one(rng):
        def step(rng, _):
            rng, krng = jax.random.split(rng)
            return rng, jax.random.gumbel(krng, (width,))
        rng, gs = jax.lax.scan(step, rng, None, length=n_steps)
        return gs, rng
    return jax.vmap(one)(rngs)


def jax_leaf_noise(key, like):
    """JAX's ``corrupt_deltas`` noise for ``key``: ``split(key, n_leaves)``
    in the tree's leaf order, one standard normal draw per leaf; as
    {dotted name: numpy}."""
    paths, _ = jax.tree_util.tree_flatten_with_path(like)
    keys = jax.random.split(key, len(paths))
    return {".".join(p.key for p in path): np.asarray(
        jax.random.normal(k, leaf.shape, leaf.dtype))
        for k, (path, leaf) in zip(keys, paths)}


def head_sizes(cfg):
    return (cfg.n_res, cfg.n_bs, cfg.n_mt)


@partial(jax.jit, static_argnums=(1, 2, 3))
def jax_sim_noise(key, n_intervals, n_agents, sizes):
    """The Gumbel noise ``repro.sim.harness.simulate_fleet`` draws from
    ``key``: ``rng, k = split(rng)`` per interval, ``split(k, A)`` per
    agent, then ``split(key, 3)`` per head. Returns (T, A, sum(sizes))."""
    def one(kk):
        ks = jax.random.split(kk, 3)
        return jnp.concatenate([jax.random.gumbel(ks[i], (n,))
                                for i, n in enumerate(sizes)])

    def step(rng, _):
        rng, k = jax.random.split(rng)
        return rng, jax.vmap(one)(jax.random.split(k, n_agents))
    _, gs = jax.lax.scan(step, key, None, length=n_intervals)
    return gs


def first_divergence(slot_a, do_a, slot_b, do_b):
    """{agent: first t where the two decision traces differ}."""
    diff = (np.asarray(slot_a) != np.asarray(slot_b)) | \
        (np.asarray(do_a) != np.asarray(do_b))
    return {int(a): int(np.flatnonzero(diff[a])[0])
            for a in np.flatnonzero(diff.any(1))}


def near_tie_gap(score_before, d_a, d_b, slot_a, slot_b):
    """The smallest score gap that could flip the decision at a
    divergence: candidate vs the min stored score (insert test), or the
    two chosen slots' scores (argmin)."""
    m = float(np.min(score_before))
    gaps = [abs(float(d_a) - m), abs(float(d_b) - m)]
    if slot_a != slot_b:
        gaps.append(abs(float(score_before[slot_a])
                        - float(score_before[slot_b])))
    return min(gaps)


# ---------------------------------------------------------------------------
# tests of the helpers
# ---------------------------------------------------------------------------
def test_gumbel_replay_reproduces_jax_categorical():
    """``categorical(k, l) == argmax(gumbel(k, l.shape) + l)`` on the
    keys ``sample_actions`` uses: the replayed noise picks JAX's actions."""
    cfg = JCfg()
    rng = np.random.default_rng(0)
    a = 6
    keys = jax.random.split(jax.random.PRNGKey(3), a)
    noise, _ = jax_episode_noise(keys, 1, head_sizes(cfg))
    logits = jnp.asarray(rng.normal(size=(a, 15)), jnp.float32)
    parts = np.split(np.asarray(logits), [4, 11], axis=-1)
    gparts = np.split(np.asarray(noise[:, 0]), [4, 11], axis=-1)
    for i in range(a):
        _, krng = jax.random.split(keys[i])
        ks = jax.random.split(krng, 3)
        for h in range(3):
            want = int(jax.random.categorical(ks[h], jnp.asarray(parts[h][i])))
            assert want == int(np.argmax(gparts[h][i] + parts[h][i]))


def test_sample_actions_with_replayed_noise_matches_jax():
    from repro_torch.core.agent import ActionMask, sample_actions
    from repro_torch.core.agent import tensors_from_numpy
    cfg = JCfg()
    params = jax_agents(cfg, 5, jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    obs = jnp.asarray(rng.normal(size=(5, 8)), jnp.float32)
    masks = rng.random((5, 15)) < 0.7
    masks[:, [0, 4, 11]] = True                  # one valid option per head
    jm = JMask(jnp.asarray(masks[:, :4]), jnp.asarray(masks[:, 4:11]),
               jnp.asarray(masks[:, 11:]))
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    act, logp, _ = jax.jit(jax.vmap(
        lambda p, s, m, k: j_sample_actions(cfg, p, s, m, k)))(
        params, obs, jm, keys)
    g = []
    for k in keys:
        ks = jax.random.split(k, 3)
        g.append(np.concatenate([np.asarray(jax.random.gumbel(ks[i], (n,)))
                                 for i, n in enumerate(head_sizes(cfg))]))
    tm = ActionMask(*(torch.as_tensor(masks[:, s]) for s in
                      (slice(0, 4), slice(4, 11), slice(11, 15))))
    t_act, t_logp, _ = sample_actions(TCfg(),
                                      tensors_from_numpy(np_tree(params),
                                                         "cpu"),
                                      torch.tensor(np.asarray(obs)), tm,
                                      gumbel=torch.tensor(np.stack(g)))
    exact(t_act, act)
    close(t_logp, logp)


def test_sample_actions_draws_from_generator_without_noise():
    """Without pre-drawn noise the actions come from the generator:
    reproducible per seed, valid under the mask."""
    from repro_torch.core.agent import agent_init, full_mask, sample_actions
    cfg = TCfg()
    gen = torch.Generator().manual_seed(0)
    pol = agent_init(cfg, 3, gen, "cpu")
    mask = full_mask(cfg, 3, "cpu")
    mask.bs[:, 3:] = False
    obs = torch.randn(3, 8, generator=gen)
    outs = [sample_actions(cfg, pol.params(), obs, mask,
                           generator=torch.Generator().manual_seed(5))[0]
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert int(outs[0][:, 1].max()) < 3
