"""The port's FL round — K2's plain version, the per-leaf codec, transport,
Eq. 7 selection, Algorithm 1, the pod merge and ``fl_round`` — against the
JAX package on the CPU (``fl_round`` itself: tests/test_torch_fleet.py).

Codec outputs are compared bit for bit (as uint32 patterns), against the
jnp oracle and the Pallas ``delta_codec`` kernel in interpret mode; floats
elsewhere within rtol 1e-4 / atol 1e-5 (the segment sums run in another
order); selections and counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import federated as jfed
from repro.core.agent import ActionMask as JMask
from repro.fl import codec as jcodec
from repro.fl import transport as jtr
from repro.kernels import ref as jref
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import federated as tfed
from repro_torch.core.agent import ActionMask, tensors_from_numpy
from repro_torch.fl import codec as tcodec
from repro_torch.fl import transport as ttr
from repro_torch.kernels.delta_codec import delta_codec, delta_codec_leaves
from repro_torch.kernels.ref import delta_codec_ref
from test_torch_support import (close, exact, jax_agents,
                                np_tree, to_rollout)

LEAF_SIZES = (512, 64, 3072, 48, 48, 1, 192, 4, 364, 7, 208, 4)


def bits(x):
    x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


def codec_rows(rng, a, l, kind):
    if kind == "random":
        return (rng.normal(size=(a, l)) * 0.01).astype(np.float32), \
            (rng.normal(size=(a, l)) * 0.001).astype(np.float32)
    # quarters with max |x| = 63.5: the int8 scale is exactly 0.5, so odd
    # quarters are exact halfway cases; and |x| ties abound for topk
    x = (rng.integers(-254, 255, (a, l)) / 4.0).astype(np.float32)
    x[:, 0] = 63.5
    return x, np.zeros_like(x)


@pytest.mark.parametrize("codec", ["float32", "int8", "topk"])
@pytest.mark.parametrize("kind", ["random", "grid"])
def test_codec_bit_identical_to_jax_at_every_leaf_size(codec, kind):
    rng = np.random.default_rng(
        ["float32", "int8", "topk"].index(codec) * 2 + (kind == "grid"))
    j = jax.jit(jax.vmap(lambda d, r, k: jref.delta_codec_ref(
        d, r, codec=codec, k=k), in_axes=(0, 0, None)), static_argnums=2)
    for l in LEAF_SIZES:
        d, r = codec_rows(rng, 3, l, kind)
        k = ttr.topk_k(l, 0.05)
        dec_j, res_j = j(d, r, k)
        dec_t, res_t = delta_codec(torch.tensor(d), torch.tensor(r),
                                   codec=codec, k=k)
        exact(bits(dec_t), bits(dec_j), f"decoded L={l}")
        exact(bits(res_t), bits(res_j), f"residual L={l}")
        if codec == "topk" and k < l:
            assert int((bits(res_t) == 0).sum(1).min()) >= k


def test_int8_halfway_cases_round_to_even():
    """frac = x/scale lands exactly on .5: rounded half to even (jnp.round
    and torch.round), not away from zero (roundf)."""
    x = np.array([[63.5, 0.25, 0.75, -0.25, -1.25, 1.75]], np.float32)
    dec, res = delta_codec(torch.tensor(x), torch.zeros(1, 6), codec="int8")
    # scale 0.5: frac = 0.5, 1.5, -0.5, -2.5, 3.5 -> q = 0, 2, -0, -2, 4
    exact(dec[0, 1:], np.array([0.0, 1.0, -0.0, -1.0, 2.0], np.float32))
    close(dec + res, x)


@pytest.mark.pallas
@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_codec_bit_identical_to_pallas_kernel(codec):
    from repro.kernels import ops as kops
    rng = np.random.default_rng(3)
    for l in (48, 364, 3072):
        d, r = codec_rows(rng, 2, l, "grid" if l == 364 else "random")
        k = ttr.topk_k(l, 0.05)
        dec_j, res_j = kops.delta_codec(jnp.asarray(d), jnp.asarray(r),
                                        codec=codec, k=k)
        dec_t, res_t = delta_codec(torch.tensor(d), torch.tensor(r),
                                   codec=codec, k=k)
        exact(bits(dec_t), bits(dec_j), f"decoded L={l}")
        exact(bits(res_t), bits(res_j), f"residual L={l}")


def segmented_round(rng, a=5):
    """All 12 iAgent leaves, each of ``a`` rows: random deltas with random
    residuals; the quarter grid (exact int8 halfway cases, |x| ties); a row
    holding NaN, +inf and -inf; an all-zero row (the 1e-12 scale floor);
    random again. Budgets ceil(0.05 L), except k = L for the leaf of 7 and
    k > L for the last leaf of 4 (k >= L keeps the whole row)."""
    ds, rs = [], []
    for l in LEAF_SIZES:
        d, r = codec_rows(rng, a, l, "random")
        d[1], r[1] = codec_rows(rng, 1, l, "grid")[0][0], 0.0
        d[2, 0], d[2, l // 2], d[2, -1] = np.nan, np.inf, -np.inf
        d[3], r[3] = 0.0, 0.0
        ds.append(d)
        rs.append(r)
    ks = [ttr.topk_k(l, 0.05) for l in LEAF_SIZES]
    ks[LEAF_SIZES.index(7)] = 7
    ks[-1] = 9
    return ds, rs, ks


@pytest.mark.parametrize("kind", ["oracle", pytest.param(
    "pallas", marks=pytest.mark.pallas)])
@pytest.mark.parametrize("codec", ["float32", "int8", "topk"])
def test_segmented_codec_matches_jax_per_leaf(codec, kind):
    """``delta_codec_leaves`` (one call over the 12 leaves, the CPU path)
    against the JAX package per leaf: ``vmap(ref.delta_codec_ref)`` or the
    Pallas ``delta_codec`` in interpret mode; bit for bit, NaN payloads
    included."""
    from repro.kernels.delta_codec import delta_codec as j_pallas_codec
    ds, rs, ks = segmented_round(np.random.default_rng(11))
    decs, ress = delta_codec_leaves([torch.tensor(d) for d in ds],
                                    [torch.tensor(r) for r in rs],
                                    codec=codec, ks=ks)
    assert len(decs) == len(ress) == len(LEAF_SIZES)
    for d, r, k, dec_t, res_t in zip(ds, rs, ks, decs, ress):
        if kind == "pallas":
            dec_j, res_j = j_pallas_codec(jnp.asarray(d), jnp.asarray(r),
                                          codec=codec, k=k, interpret=True)
        else:
            dec_j, res_j = jax.vmap(lambda x, y: jref.delta_codec_ref(
                x, y, codec=codec, k=k))(jnp.asarray(d), jnp.asarray(r))
        msg = f"{codec} L={d.shape[1]} k={k}"
        exact(bits(dec_t), bits(dec_j), f"decoded {msg}")
        exact(bits(res_t), bits(res_j), f"residual {msg}")
        if codec == "topk" and k >= d.shape[1]:
            assert not bits(res_t).any(), msg      # the whole row is kept
    one = delta_codec(torch.tensor(ds[2]), torch.tensor(rs[2]), codec=codec,
                      k=ks[2])
    exact(bits(one[0]), bits(decs[2]))
    exact(bits(one[1]), bits(ress[2]))


def test_segmented_codec_checks_its_arguments():
    d = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="unknown codec"):
        delta_codec_leaves([d], [d], codec="fp8", ks=[1])
    with pytest.raises(ValueError, match="the same number"):
        delta_codec_leaves([d, d], [d], codec="int8", ks=[1, 1])
    with pytest.raises(ValueError, match="the same number"):
        delta_codec_leaves([], [], codec="int8", ks=[])


def params_pair(a, seed):
    pj = jax_agents(JCfg(), a, jax.random.PRNGKey(seed))
    return pj, tensors_from_numpy(np_tree(pj), "cpu")


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_codec_roundtrip_per_leaf_matches_jax(codec):
    """Per leaf: flatten to (A, L), own scale / own k, error feedback."""
    dj, dt = params_pair(3, 1)
    rj, rt = params_pair(3, 2)
    rj = jax.tree.map(lambda x: 0.01 * x, rj)
    rt = {k: 0.01 * v for k, v in rt.items()}
    tcfg_j = jtr.TransportConfig(codec=codec, topk_frac=0.1)
    tcfg_t = ttr.TransportConfig(codec=codec, topk_frac=0.1)
    dec_j, res_j = jax.jit(lambda d, r: jcodec.codec_roundtrip(
        d, r, tcfg_j))(dj, rj)
    dec_t, res_t = tcodec.codec_roundtrip(dt, rt, tcfg_t)
    from repro_torch.core.agent import _flatten
    for name, want in _flatten(np_tree(dec_j)).items():
        exact(bits(dec_t[name]), bits(want), name)
    for name, want in _flatten(np_tree(res_j)).items():
        exact(bits(res_t[name]), bits(want), name)


def test_transport_accounting_matches_jax():
    pj, pt = params_pair(4, 0)
    bw = np.array([2.0, 5.0, 17.0, 40.0], np.float32)
    for codec in ("float32", "int8", "topk"):
        cj = jtr.TransportConfig(codec=codec, deadline_s=0.01)
        ct = ttr.TransportConfig(codec=codec, deadline_s=0.01)
        up_j = jtr.agent_payload_bytes(pj, cj, stacked=True)
        up_t = ttr.agent_payload_bytes(pt.values(), ct)
        assert up_j == up_t
        assert jtr.full_param_bytes(pj, stacked=True) == \
            ttr.full_param_bytes(pt.values())
        assert jtr.downlink_bytes(cj, 4, 2, up_j, 7.0) == \
            ttr.downlink_bytes(ct, 4, 2, up_t, 7.0)
        s_j = jtr.uplink_seconds(up_j, jnp.asarray(bw))
        s_t = ttr.uplink_seconds(up_t, torch.tensor(bw))
        close(s_t, s_j)
        exact(ttr.on_time_mask(s_t, 0.01), jtr.on_time_mask(s_j, 0.01))
        exact(ttr.on_time_mask(s_t, 0.0), jtr.on_time_mask(s_j, 0.0))


def stats_pair(mem, comp, div, bw, avail):
    arrs = [np.asarray(x, np.float32) for x in (mem, comp, div, bw)]
    return (jfed.ClientStats(*(jnp.asarray(x) for x in arrs),
                             available=jnp.asarray(avail)),
            tfed.ClientStats(*(torch.tensor(x) for x in arrs),
                             available=torch.tensor(avail)))


@pytest.mark.parametrize("case", ["ties", "random"])
def test_select_clients_matches_jax(case):
    """Stable top-k: equal utilities go to the lower index; unavailable
    clients sit at -inf and are never selected."""
    rng = np.random.default_rng(9)
    a = 9
    if case == "ties":
        mem = comp = div = np.full(a, 0.5)
        bw = np.full(a, 10.0)
    else:
        mem, comp = rng.random(a), rng.random(a)
        div, bw = rng.normal(size=a), rng.uniform(2, 40, a)
    avail = rng.random(a) < 0.7
    avail[[0, 3]] = False
    sj, st = stats_pair(mem, comp, div, bw, avail)
    close(tfed.total_utility(st), jfed.total_utility(sj))
    for frac in (0.5, 0.3, 1.0):
        sel_j = jfed.select_clients(JCfg(clients_per_round=frac), sj)
        sel_t = tfed.select_clients(TCfg(clients_per_round=frac), st)
        exact(sel_t, sel_j, f"frac={frac}")


def hetero_masks(a):
    m = np.ones((a, 15), bool)
    m[1::2, 9:11] = False          # two batch-size groups
    m[2::3, 3] = False             # two resolution groups
    parts = (slice(0, 4), slice(4, 11), slice(11, 15))
    return (JMask(*(jnp.asarray(m[:, s]) for s in parts)),
            ActionMask(*(torch.tensor(m[:, s]) for s in parts)))


def test_aggregate_and_merge_match_jax():
    """Alg. 1 (mean) over two pods with several head groups: the segment
    sums (``index_add_``), the per-pod base broadcast to groups
    (``repeat_interleave``), the no-contributor fallback; then the pod
    merge."""
    a, p = 8, 2
    rng = np.random.default_rng(10)
    pj, pt = params_pair(a, 4)
    bj, bt = params_pair(p, 5)
    jm, tm = hetero_masks(a)
    hg = jfed.head_group_ids(jm)
    ids_t, counts_t = tfed.head_group_ids(tm, "cpu")
    for key in ids_t:
        exact(ids_t[key], hg[key])
        assert counts_t[key] == hg[f"{key}_count"]
    sel = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    losses = rng.normal(size=(a, 3)).astype(np.float32)
    pods = np.arange(a) % p
    new_j, base_j = jax.jit(lambda *xs: jfed.aggregate(
        JCfg(), *xs[:4], hg, xs[4], p))(pj, bj, jnp.asarray(sel),
                                         jnp.asarray(losses),
                                         jnp.asarray(pods, jnp.int32))
    new_t, base_t = tfed.aggregate(TCfg(), pt, bt, torch.tensor(sel),
                                   torch.tensor(losses), ids_t, counts_t,
                                   torch.tensor(pods), p)
    from repro_torch.core.agent import _flatten
    for name, want in _flatten(np_tree(new_j)).items():
        close(new_t[name], want, name)
    for name, want in _flatten(np_tree(base_j)).items():
        close(base_t[name], want, name)
    merged_j = _flatten(np_tree(jax.jit(jfed.merge_pods)(base_j)))
    for name, got in tfed.merge_pods(base_t).items():
        close(got, merged_j[name], name)


def test_schedule_and_availability_streams_match():
    for fl_every, n in ((1, 5), (2, 9), (3, 10)):
        sj = jfed.fl_schedule(JCfg(fl_every=fl_every), n)
        exact(tfed.fl_schedule(TCfg(fl_every=fl_every), n), sj)
        exact(tfed.draw_availability(sj, 6, 0.3, seed=4),
              jfed.draw_availability(sj, 6, 0.3, seed=4))
    exact(tfed.fl_schedule(TCfg(), 4, learn=False),
          jfed.fl_schedule(JCfg(), 4, learn=False))


def test_per_head_losses_value_and_detach_gradient():
    """``stop_gradient`` -> ``detach``: the ratio is 1 at the evaluation
    point but its gradient is d logp; values and gradients match JAX."""
    from repro.core.ppo import Rollout as JRollout
    a, t = 4, 10
    rng = np.random.default_rng(2)
    pj, _ = params_pair(a, 6)
    roll = dict(states=rng.normal(size=(a, t, 8)),
                actions=np.stack([rng.integers(0, n, (a, t))
                                  for n in (3, 5, 4)], -1),
                logp_old=-1 - np.abs(rng.normal(size=(a, t))),
                rewards=np.tanh(rng.normal(size=(a, t))),
                values_old=0.1 * rng.normal(size=(a, t)))
    roll = {k: v.astype(np.int32 if k == "actions" else np.float32)
            for k, v in roll.items()}
    jm, tm = hetero_masks(a)
    val_j, grad_j = jax.jit(jax.vmap(lambda p, r, m: jax.value_and_grad(
        lambda q: jfed.per_head_losses(JCfg(), q, r, m).sum())(p)))(
        pj, JRollout(**roll), jm)
    pt = {k: v.requires_grad_(True) for k, v in
          tensors_from_numpy(np_tree(pj), "cpu").items()}
    losses = tfed.per_head_losses(TCfg(), pt, to_rollout(JRollout(**roll)),
                                  tm)
    close(losses.sum(-1), val_j)
    grads = torch.autograd.grad(losses.sum(), list(pt.values()),
                                allow_unused=True)
    from repro_torch.core.agent import _flatten
    gj = _flatten(np_tree(grad_j))
    for (name, _), g in zip(pt.items(), grads):
        close(torch.zeros_like(pt[name]) if g is None else g, gj[name],
              f"grad {name}")


def test_transport_config_and_metric_keys_match_jax():
    """``async_rounds`` / ``staleness_decay`` with the JAX defaults; a
    round is ``plain`` (the codec skipped) only for the float32 codec in
    synchronous rounds; the round metrics carry the JAX package's six
    keys, zero on an episode without a round."""
    assert ttr.TransportConfig() == ttr.DEFAULT_TRANSPORT
    for f in ("codec", "topk_frac", "deadline_s", "async_rounds",
              "staleness_decay"):
        assert getattr(ttr.DEFAULT_TRANSPORT, f) == \
            getattr(jtr.DEFAULT_TRANSPORT, f), f
    for codec in ttr.CODECS:
        for async_rounds in (False, True):
            kw = dict(codec=codec, deadline_s=0.01,
                      async_rounds=async_rounds)
            assert ttr.TransportConfig(**kw).plain == \
                jtr.TransportConfig(**kw).plain
    assert ttr.FL_METRIC_KEYS == jtr.FL_METRIC_KEYS
    zeros = ttr.fl_zero_metrics("cpu")
    assert tuple(zeros) == jtr.FL_METRIC_KEYS
    assert all(float(v) == 0.0 for v in zeros.values())
