"""The port's chaos layer against the JAX package on the CPU: the robust
Algorithm 1 statistics, the delta clip, the partitioned pod merge, the
staleness buffer, the fault plan, crashes and byzantine corruption, and
``fl_round`` under the guard, fault and async combinations.

Inputs are made from fixed numpy seeds and go through both packages.
Masks, ranks, counts, timers and the fault plan are compared exactly; the
median (``0.5 * (lo + hi)`` of sorted values) and the corruption bit for
bit; sums (the trimmed mean, the clip's norms, Algorithm 1) within
rtol 1e-4 / atol 1e-5, since they add in another order than XLA. The JAX
``noise`` draws (threefry) are passed to the port as inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import federated as jfed
from repro.core import fleet as jfleet
from repro.core.backends import FLUID
from repro.fl import staleness as jstale
from repro.fl import transport as jtr
from repro.resilience import faults as jfaults
from repro.resilience import guards as jguards
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import federated as tfed
from repro_torch.core import fleet as tfleet
from repro_torch.core.agent import _flatten, tensors_from_numpy
from repro_torch.fl import staleness as tstale
from repro_torch.fl import transport as ttr
from repro_torch.resilience import faults as tfaults
from repro_torch.resilience import guards as tguards
from test_torch_support import (close, close_tree, exact, jax_agents,
                                jax_fleet_tree, jax_leaf_noise, np_tree,
                                to_rollout)

A, P = 8, 2
CFG_J, CFG_T = JCfg(fl_every=1), TCfg(fl_every=1)
T = lambda x: torch.tensor(np.asarray(x))


def bits(x):
    x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def named(tree):
    """{dotted name: numpy} of a JAX params-like tree."""
    return _flatten(np_tree(tree))


# ---------------------------------------------------------------------------
# configs and the fault plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(crash_prob=1.5), dict(byzantine_frac=-0.1), dict(partition_prob=2),
    dict(byzantine_mode="nope"), dict(crash_recovery=0),
    dict(partition_merges=0)])
def test_fault_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        jfaults.FaultConfig(**kw)
    with pytest.raises(ValueError) as got:
        tfaults.FaultConfig(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(agg="mode"), dict(trim_frac=0.5), dict(trim_frac=-0.1),
    dict(clip_factor=-1.0), dict(susp_threshold=1.5)])
def test_guard_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        jguards.GuardConfig(**kw)
    with pytest.raises(ValueError) as got:
        tguards.GuardConfig(**kw)
    assert str(got.value) == str(want.value)


def test_suspicion_gate_waits_for_the_health_observatory():
    """Both packages accept a threshold, which gates selection once the
    health observatory is on (``tests/test_torch_health.py``)."""
    assert tguards.GuardConfig(susp_threshold=0.5) == \
        tguards.GuardConfig(**vars(jguards.GuardConfig(susp_threshold=0.5)))
    assert tguards.GuardConfig() == tguards.DEFAULT_GUARDS
    assert tguards.AGG_METHODS == jguards.AGG_METHODS
    assert tfed.AGG_METHODS == jfed.AGG_METHODS


def test_fault_config_properties_match_jax():
    for kw in (dict(), dict(crash_prob=0.1), dict(byzantine_frac=0.2),
               dict(partition_prob=0.3), dict(crash_prob=0.1,
                                              partition_prob=0.3)):
        j, t = jfaults.FaultConfig(**kw), tfaults.FaultConfig(**kw)
        for name in ("crash_active", "byzantine_active", "partition_active",
                     "active"):
            assert getattr(t, name) == getattr(j, name), (kw, name)
    assert dataclasses.asdict(tfaults.NO_FAULTS) == \
        dataclasses.asdict(jfaults.NO_FAULTS)
    assert tfaults.BYZANTINE_MODES == jfaults.BYZANTINE_MODES


@pytest.mark.parametrize("fl_every,n_eps", [(1, 9), (2, 12), (3, 10)])
def test_fault_plan_is_jax_bit_for_bit(fl_every, n_eps):
    sch = jfed.fl_schedule(JCfg(fl_every=fl_every), n_eps)
    for kw in (dict(crash_prob=0.2, byzantine_frac=0.3, partition_prob=0.5,
                    seed=3),
               dict(byzantine_frac=0.4, seed=1), dict(crash_prob=0.3),
               dict()):
        pj = jfaults.draw_fault_plan(sch, 6, 3, jfaults.FaultConfig(**kw))
        pt = tfaults.draw_fault_plan(sch, 6, 3, tfaults.FaultConfig(**kw))
        for a, b in zip(pt, pj):
            exact(a, b, str(kw))
    assert tfaults.draw_fault_plan(sch, 6, 3, None).crash.sum() == 0


# ---------------------------------------------------------------------------
# robust Algorithm 1, the clip and the merge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m", [1, 2, 5, 8])
@pytest.mark.parametrize("trim", [0.0, 0.2, 0.49])
def test_robust_stat_matches_jax(m, trim):
    """Random validity masks (at least one valid entry per row; n = 1, even
    and odd n), NaN and inf among the invalid entries: the median bit for
    bit, the trimmed mean within the band."""
    rng = np.random.default_rng(m * 100 + int(trim * 100))
    s = 6
    vals = rng.normal(size=(s, m, 3, 2)).astype(np.float32)
    valid = rng.random((s, m)) < 0.6
    valid[np.arange(s), rng.integers(0, m, s)] = True
    valid[0] = False
    valid[0, 0] = True                           # n = 1
    vals[~valid] = rng.choice([np.nan, np.inf, 1e9], size=(~valid).sum())[
        :, None, None]
    for method in ("median", "trimmed"):
        want = jfed._robust_stat(jnp.asarray(vals), jnp.asarray(valid),
                                 method, trim)
        got = tfed._robust_stat(T(vals), T(valid), method, trim)
        if method == "median":
            exact(bits(got), bits(want), method)
        else:
            close(got, want, method)


@settings(derandomize=True, max_examples=40, deadline=None)
@given(honest=st.lists(st.floats(-100, 100, width=32,
                                 allow_subnormal=False),
                       min_size=2, max_size=7),
       n_byz=st.integers(0, 6), sign=st.sampled_from([-1.0, 1.0]))
def test_robust_stat_stays_in_the_honest_range(honest, n_byz, sign):
    """With f byzantine values among n, the trimmed mean (per-side trim at
    least f) and the median (f <= (n-1)//2) stay inside the honest range,
    and equal the JAX package's."""
    f = min(n_byz, len(honest) - 1)
    vals = np.asarray(honest + [sign * 1e9] * f, np.float32)
    n = len(vals)
    padded = np.concatenate([vals, np.full(2, 7e7, np.float32)])[None]
    valid = np.asarray([True] * n + [False] * 2)[None]
    lo, hi = min(honest), max(honest)
    tr = min((f + 0.25) / n, 0.4999)
    got = float(tfed._robust_stat(T(padded), T(valid), "trimmed", tr)[0])
    assert lo - 1e-3 <= got <= hi + 1e-3
    close(got, jfed._robust_stat(jnp.asarray(padded), jnp.asarray(valid),
                                 "trimmed", tr))
    if f <= (n - 1) // 2:
        md = tfed._robust_stat(T(padded), T(valid), "median", 0.0)
        assert lo - 1e-3 <= float(md[0]) <= hi + 1e-3
        exact(bits(md), bits(jfed._robust_stat(
            jnp.asarray(padded), jnp.asarray(valid), "median", 0.0)))


def hetero_masks(a):
    from repro.core.agent import ActionMask as JMask
    from repro_torch.core.agent import ActionMask
    m = np.ones((a, 15), bool)
    m[1::2, 9:11] = False          # two batch-size groups
    m[2::3, 3] = False             # two resolution groups
    parts = (slice(0, 4), slice(4, 11), slice(11, 15))
    return (JMask(*(jnp.asarray(m[:, s]) for s in parts)),
            ActionMask(*(torch.tensor(m[:, s]) for s in parts)))


@pytest.mark.parametrize("p", [1, 2])
@pytest.mark.parametrize("method", ["mean", "trimmed", "median"])
def test_aggregate_every_method_matches_jax(p, method):
    """Algorithm 1 with each statistic over P pods and several head groups,
    one pod group left without a contributor (its agents keep their own
    heads)."""
    rng = np.random.default_rng(p * 10 + len(method))
    pj = jax_agents(JCfg(), A, jax.random.PRNGKey(4))
    bj = jax_agents(JCfg(), p, jax.random.PRNGKey(5))
    jm, tm = hetero_masks(A)
    hg = jfed.head_group_ids(jm)
    ids_t, counts_t = tfed.head_group_ids(tm, "cpu")
    sel = np.array([1, 0, 1, 1, 0, 0, 1, 1], bool)
    losses = rng.normal(size=(A, 3)).astype(np.float32)
    pods = (np.arange(A) % p).astype(np.int32)
    new_j, base_j = jax.jit(lambda *xs: jfed.aggregate(
        JCfg(), *xs[:4], hg, xs[4], p, method=method, trim_frac=0.25))(
        pj, bj, jnp.asarray(sel), jnp.asarray(losses), jnp.asarray(pods))
    new_t, base_t = tfed.aggregate(
        TCfg(), tensors_from_numpy(np_tree(pj), "cpu"),
        tensors_from_numpy(np_tree(bj), "cpu"), T(sel), T(losses), ids_t,
        counts_t, T(pods).long(), p, method=method, trim_frac=0.25)
    for name, want in named(new_j).items():
        close(new_t[name], want, name)
    for name, want in named(base_j).items():
        close(base_t[name], want, name)
    with pytest.raises(ValueError, match="unknown aggregation method"):
        tfed.aggregate(TCfg(), new_t, base_t, T(sel), T(losses), ids_t,
                       counts_t, T(pods).long(), p, method="mode")


def test_clip_deltas_and_median_match_jax():
    """Per-leaf norms against the selected clients' median: one scaled-up
    client clipped, the unselected ones untouched, an empty selection
    clips nothing (its median is +inf)."""
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(A, 6, 4)).astype(np.float32),
            "b": rng.normal(size=(A, 4)).astype(np.float32)}
    tree["w"][2] *= 40.0
    tree["b"][5] *= 40.0
    for sel in (np.array([1, 1, 1, 0, 1, 1, 0, 1], bool),
                np.array([0, 0, 1, 0, 0, 0, 0, 0], bool),
                np.zeros(A, bool)):
        cj, nj = jguards.clip_deltas(
            {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(sel),
            3.0)
        ct, nt = tguards.clip_deltas({k: T(v) for k, v in tree.items()},
                                     T(sel), 3.0)
        assert float(nt) == float(nj)
        for k in tree:
            close(ct[k], cj[k], k)
        x = rng.normal(size=A).astype(np.float32)
        exact(bits(tguards._masked_median_1d(T(x), T(sel))),
              bits(jguards._masked_median_1d(jnp.asarray(x),
                                             jnp.asarray(sel))))
    assert float(tguards.clip_deltas(
        {k: T(v) for k, v in tree.items()},
        T(np.array([1, 1, 1, 0, 1, 1, 0, 1], bool)), 3.0)[1]) == 2


@pytest.mark.parametrize("active", [[True, False, True], [False] * 3,
                                    [True] * 3, None])
def test_merge_pods_partitioned_matches_jax(active):
    bj = jax_agents(JCfg(), 3, jax.random.PRNGKey(7))
    act = None if active is None else np.asarray(active)
    want = named(jfed.merge_pods(bj, None if act is None
                                 else jnp.asarray(act)))
    got = tfed.merge_pods(tensors_from_numpy(np_tree(bj), "cpu"),
                          None if act is None else T(act))
    for name, w in want.items():
        close(got[name], w, name)
        if act is not None:
            exact(got[name][~act], w[~act], name)   # partitioned: untouched


# ---------------------------------------------------------------------------
# the staleness buffer
# ---------------------------------------------------------------------------
def pending_pair(rng, like_j):
    """A JAX ``PendingDeltas`` and the port's, with parked deltas, random
    staleness and one non-finite parked delta."""
    delta = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=x.shape).astype(np.float32)), like_j)
    w = delta["head_bs"]["w"].at[3, 0, 0].set(jnp.inf)
    delta = dict(delta, head_bs=dict(delta["head_bs"], w=w))
    has = rng.random(A) < 0.6
    has[3] = True
    stale = rng.integers(0, 4, A).astype(np.int32) * has
    pj = jstale.PendingDeltas(delta, jnp.asarray(stale), jnp.asarray(has))
    pt = tstale.PendingDeltas(tensors_from_numpy(np_tree(delta), "cpu"),
                              T(stale), T(has))
    return pj, pt


def assert_pending_equal(pt, pj):
    exact(pt.has, pj.has, "has")
    exact(pt.staleness, pj.staleness, "staleness")
    for name, w in named(pj.delta).items():
        exact(bits(pt.delta[name]), bits(w), name)


def test_staleness_functions_match_jax():
    rng = np.random.default_rng(5)
    like = jax_agents(JCfg(), A, jax.random.PRNGKey(1))
    init_t = tstale.pending_init(tensors_from_numpy(np_tree(like), "cpu"))
    assert_pending_equal(init_t, jstale.pending_init(like))

    pj, pt = pending_pair(rng, like)
    vj, dj = jstale.validate_pending(pj)
    vt, dt = tstale.validate_pending(pt)
    assert_pending_equal(vt, vj)
    assert float(dt) == float(dj) == 1.0
    for decay in (0.5, 0.3):
        exact(bits(tstale.stale_weights(vt, decay)),
              bits(jstale.stale_weights(vj, decay)))

    decoded_j = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=x.shape).astype(np.float32)), like)
    decoded_t = tensors_from_numpy(np_tree(decoded_j), "cpu")
    fresh = rng.random(A) < 0.5
    w = jstale.stale_weights(vj, 0.5)
    mj = jstale.merge_contributions(decoded_j, vj, jnp.asarray(fresh), w)
    mt = tstale.merge_contributions(decoded_t, vt, T(fresh), T(w))
    for name, want in named(mj).items():
        exact(bits(mt[name]), bits(want), name)

    sel = rng.random(A) < 0.6
    parked = sel & ~fresh
    consumed = sel & np.asarray(vj.has) & fresh
    fresh_sent = sel & fresh
    uj = jstale.update_pending(vj, decoded_j, jnp.asarray(parked),
                               jnp.asarray(consumed), jnp.asarray(fresh_sent))
    ut = tstale.update_pending(vt, decoded_t, T(parked), T(consumed),
                               T(fresh_sent))
    assert_pending_equal(ut, uj)


# ---------------------------------------------------------------------------
# crashes and byzantine corruption
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def episode_pair():
    """One JAX episode at A=8, P=2 from a fresh fleet: the fleets before
    and after, the rollout, and the port's fleet after the episode."""
    jf0 = jfleet.fleet_init(CFG_J, A, jax.random.PRNGKey(2), n_pods=P)
    rates = jnp.asarray(np.random.default_rng(3).uniform(
        5, 150, (A, CFG_J.n_steps)), jnp.float32)
    jf, roll, _ = jfleet.fleet_episode(CFG_J, jf0, rates, learn=True,
                                       backend=FLUID, health=None)
    return jf0, jf, roll


@pytest.mark.parametrize("zero_params", [True, False])
def test_apply_crashes_matches_jax(episode_pair, zero_params):
    """Agents already down get their pre-episode state back, an expiring
    window rejoins warm-started from the pod base, fresh crashes start the
    timer (zeroing params and optimizer when asked)."""
    jf0, jf, _ = episode_pair
    timer = np.array([0, 1, 2, 0, 1, 0, 0, 3], np.int32)
    crash_now = np.array([1, 1, 0, 0, 0, 1, 0, 0], bool)
    faults_kw = dict(crash_prob=0.3, crash_recovery=2,
                     crash_zero_params=zero_params)
    jf = jf._replace(crash_timer=jnp.asarray(timer))
    out_j, ran_j, down_j = jfaults.apply_crashes(
        jfaults.FaultConfig(**faults_kw), jf0.astate, jf,
        jnp.asarray(crash_now))
    tf0 = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(jf0), device="cpu")
    tf = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(jf), device="cpu")
    prev = tfaults.snapshot_astate(tf0.astate)
    out_t, ran_t, down_t = tfaults.apply_crashes(
        tfaults.FaultConfig(**faults_kw), prev, tf, T(crash_now))
    exact(ran_t, ran_j)
    exact(down_t, down_j)
    exact(out_t.crash_timer, out_j.crash_timer)
    got, want = tfleet.fleet_to_numpy(out_t), jax_fleet_tree(out_j)
    for key in ("params", "opt", "buffer", "env_state"):
        close_tree(got[key], want[key], key + ".")


@pytest.mark.parametrize("mode", ["sign_flip", "noise", "nan"])
def test_corrupt_deltas_matches_jax(mode):
    """Each mode on the byzantine rows only, bit for bit; JAX's noise
    (``split(key, n_leaves)``, one normal draw per leaf) passed in."""
    rng = np.random.default_rng(9)
    like = jax_agents(JCfg(), A, jax.random.PRNGKey(8))
    decoded = jax.tree.map(lambda x: 0.01 * x, like)
    byz = rng.random(A) < 0.4
    key = jax.random.fold_in(jax.random.PRNGKey(4), 3)
    cfg_kw = dict(byzantine_frac=0.4, byzantine_mode=mode,
                  byzantine_scale=5.0, seed=4)
    want = named(jfaults.corrupt_deltas(jfaults.FaultConfig(**cfg_kw),
                                        decoded, jnp.asarray(byz), key))
    noise = {k: T(v) for k, v in jax_leaf_noise(key, decoded).items()}
    got = tfaults.corrupt_deltas(
        tfaults.FaultConfig(**cfg_kw),
        tensors_from_numpy(np_tree(decoded), "cpu"), T(byz),
        noise=noise if mode == "noise" else None)
    for name, w in want.items():
        exact(bits(got[name]), bits(w), name)
        exact(bits(got[name][~byz]), bits(named(decoded)[name][~byz]), name)
    if mode == "noise":          # the port's own draws: one generator seed
        gen = lambda: torch.Generator().manual_seed(4)
        a1 = tfaults.corrupt_deltas(tfaults.FaultConfig(**cfg_kw),
                                    tensors_from_numpy(np_tree(decoded),
                                                       "cpu"),
                                    T(byz), generator=gen())
        a2 = tfaults.corrupt_deltas(tfaults.FaultConfig(**cfg_kw),
                                    tensors_from_numpy(np_tree(decoded),
                                                       "cpu"),
                                    T(byz), generator=gen())
        for k in a1:
            exact(a1[k], a2[k], k)


# ---------------------------------------------------------------------------
# fl_round under the guard, fault and async combinations
# ---------------------------------------------------------------------------
# deadlines that the slowest links miss (int8 uploads ~4.6 KB, topk ~1.9 KB)
DEADLINES = {"float32": 0.0, "int8": 0.002, "topk": 0.0008}
ROUND_CASES = {
    # name: (codec, async, guards kwargs, faults kwargs or None)
    "int8-trimmed-clip": ("int8", False,
                          dict(agg="trimmed", trim_frac=0.25,
                               clip_factor=3.0), None),
    "topk-median": ("topk", False, dict(agg="median"), None),
    "int8-async": ("int8", True, dict(), None),
    "topk-async-trimmed-signflip": (
        "topk", True, dict(agg="trimmed", clip_factor=2.0),
        dict(byzantine_frac=0.4, byzantine_mode="sign_flip")),
    "int8-async-median-noise": (
        "int8", True, dict(agg="median"),
        dict(byzantine_frac=0.4, byzantine_mode="noise",
             byzantine_scale=3.0)),
    "int8-nan-rejected": ("int8", False, dict(),
                          dict(byzantine_frac=0.4, byzantine_mode="nan")),
    "topk-async-nan-clip": ("topk", True, dict(clip_factor=3.0),
                            dict(byzantine_frac=0.4, byzantine_mode="nan")),
    "int8-async-no-reject": ("int8", True, dict(reject_nonfinite=False),
                             None),
    "float32-signflip": ("float32", False, dict(),
                         dict(byzantine_frac=0.4)),
}


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_fl_round_chaos_matches_jax(episode_pair, case):
    """One round after one episode from a fleet with parked uploads (one
    of them non-finite), a deadline that some links miss, stragglers and
    byzantine agents: the aggregation mask exactly, the round metrics
    (counts exactly), and the new params, optimizer, bases, residuals,
    parked uploads and buffers."""
    _, jf, roll = episode_pair
    codec, async_rounds, guards_kw, faults_kw = ROUND_CASES[case]
    rng = np.random.default_rng(len(case))
    jf = jf._replace(pending=pending_pair(rng, jf.astate.params)[0])
    avail = np.array([1, 1, 0, 1, 1, 1, 0, 1], bool)
    byz = np.array([1, 0, 0, 1, 0, 1, 0, 0], bool)
    tr = dict(codec=codec, deadline_s=DEADLINES[codec],
              async_rounds=async_rounds)
    key = jax.random.fold_in(jax.random.PRNGKey(7), 2)
    fj = None if faults_kw is None else jfaults.FaultConfig(**faults_kw,
                                                             seed=7)
    jf2, sel_j, met_j = jfleet.fl_round(
        CFG_J, jf, roll, jnp.asarray(avail),
        transport=jtr.TransportConfig(**tr),
        guards=jguards.GuardConfig(**guards_kw), faults=fj,
        byzantine=None if fj is None else jnp.asarray(byz),
        fault_key=key, health=None)
    tf = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(jf), device="cpu")
    noise = None
    if faults_kw and faults_kw.get("byzantine_mode") == "noise":
        noise = {k: T(v) for k, v in
                 jax_leaf_noise(key, jf.astate.params).items()}
    tf2, sel_t, met_t = tfleet.fl_round(
        CFG_T, tf, to_rollout(roll), T(avail),
        transport=ttr.TransportConfig(**tr),
        guards=tguards.GuardConfig(**guards_kw),
        faults=None if faults_kw is None else tfaults.FaultConfig(
            **faults_kw, seed=7),
        byzantine=T(byz), byz_noise=noise)
    exact(sel_t, sel_j)
    assert set(met_t) == set(met_j) == set(ttr.FL_METRIC_KEYS)
    for k in ("fl_missed", "fl_stale_used", "fl_rejected", "fl_clipped"):
        assert float(met_t[k]) == float(met_j[k]), k
    for k in ("fl_payload_bytes", "fl_uplink_s"):
        close(met_t[k], met_j[k], k)
    if codec != "float32":
        assert float(met_j["fl_missed"]) > 0      # the deadline bites
    got, want = tfleet.fleet_to_numpy(tf2), jax_fleet_tree(jf2)
    exact(got["pending"]["has"], want["pending"]["has"])
    exact(got["pending"]["staleness"], want["pending"]["staleness"])
    close_tree(got["pending"]["delta"], want["pending"]["delta"], "pending.")
    for key_ in ("params", "opt", "base_params", "residuals", "buffer"):
        close_tree(got[key_], want[key_], key_ + ".")
