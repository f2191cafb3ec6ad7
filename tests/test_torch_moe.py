"""The port's MoE layer, MLA attention and ``sdpa_chunked``
(``repro_torch.models.moe``, ``.attention``, ``.layers``) against the JAX
package's, on the CPU, from the same numpy inputs and the same parameters
carried across by ``params_from_numpy``.

Configs: reduced granite-moe-3b-a800m (8 experts, top-2, no shared
expert) and reduced deepseek-v2-lite-16b (8 experts, top-2, one shared
expert, MLA). Floats agree within rtol 1e-4 / atol 1e-5 (the repo's
float32 band); the routing (top-k ids), the capacity, the drop mask
``keep`` and the slots are exact. JAX's ``_moe_tokens`` keeps its routing
internal, so the test reads it from ``jax_routing``, the reference's
routing lines (``repro/models/moe.py:67-84``) run with the reference's
own ``dense`` and ``moe_capacity``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import attention as jmla
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro_torch.configs.base import get_config
from repro_torch.models import attention as tmla
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(x)


def configs(name, **kw):
    return (j_get_config(name).reduced().replace(**kw),
            get_config(name).reduced().replace(**kw))


def jax_routing(p, cfg, xf):
    """The reference's routing decisions (repro/models/moe.py:67-84)."""
    t_, k = xf.shape[0], cfg.top_k
    probs = jax.nn.softmax(jl.dense(p["router"], xf).astype(jnp.float32), -1)
    topw, topi = jax.lax.top_k(probs, k)
    cap = jmoe.moe_capacity(cfg, t_)
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = jnp.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = jnp.arange(t_ * k, dtype=jnp.int32) - seg_start.astype(
        jnp.int32)
    keep = pos_in_e < cap
    slot = jnp.where(keep, sorted_e * cap + pos_in_e, cfg.n_experts * cap)
    return dict(topi=topi, order=order, keep=keep, slot=slot, cap=cap)


def moe_params(jc, tc, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jc, jnp.float32)
    return jp, params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")


MOE_CASES = [
    # (config, moe_impl, capacity_factor)
    ("granite-moe-3b-a800m", "global", 1.25),
    ("granite-moe-3b-a800m", "batched", 1.25),
    ("deepseek-v2-lite-16b", "global", 1.25),
    ("deepseek-v2-lite-16b", "batched", 1.25),
    ("granite-moe-3b-a800m", "global", 0.5),
    ("deepseek-v2-lite-16b", "batched", 0.5),
]


@pytest.mark.parametrize("name,impl,cf", MOE_CASES)
def test_moe_apply_matches_jax(name, impl, cf):
    """y and the aux loss within the band; with the shared expert (deepseek)
    and without (granite); global and per-row ("batched") dispatch."""
    jc, tc = configs(name, moe_impl=impl, capacity_factor=cf)
    assert bool(tc.n_shared_experts) == (name == "deepseek-v2-lite-16b")
    jp, tp = moe_params(jc, tc)
    x = np.random.default_rng(0).normal(size=(3, 10, tc.d_model)).astype(
        np.float32)
    want_y, want_aux = jmoe.moe_apply(jp, jc, j(x))
    got_y, got_aux = tmoe.moe_apply(tp, tc, t(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)


@pytest.mark.parametrize("cf,tokens", [(1.25, 30), (0.5, 30), (0.5, 200),
                                       (1.25, 1)])
def test_routing_capacity_and_drops_are_exact(cf, tokens):
    """Top-k ids, the sort order, the capacity, ``keep`` and the slots equal
    the reference's; at capacity factor 0.5 assignments are dropped, and
    the dropped count is the reference's."""
    jc, tc = configs("granite-moe-3b-a800m", capacity_factor=cf)
    jp, tp = moe_params(jc, tc, seed=1)
    xf = np.random.default_rng(tokens).normal(
        size=(tokens, tc.d_model)).astype(np.float32)
    want = jax_routing(jp, jc, j(xf))
    got = tmoe.moe_route(tp, tc, t(xf))
    assert got.cap == want["cap"] == tmoe.moe_capacity(tc, tokens)
    for key in ("topi", "order", "keep", "slot"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(want[key]), err_msg=key)
    drops = int((~got.keep).sum())
    assert drops == int((~want["keep"]).sum())
    if cf == 0.5 and tokens == 200:
        assert drops > 0
    np.testing.assert_allclose(got.topw.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("tokens", [0, 1, 7, 64, 1000])
def test_capacity_is_the_references(tokens):
    jc, tc = configs("deepseek-v2-lite-16b")
    assert tmoe.moe_capacity(tc, tokens) == jmoe.moe_capacity(jc, tokens)
    full = get_config("deepseek-v2-lite-16b")
    assert tmoe.moe_capacity(full, tokens) == jmoe.moe_capacity(
        j_get_config("deepseek-v2-lite-16b"), tokens)


def test_dropped_assignments_contribute_nothing():
    """At a capacity of 8 slots, 200 tokens top-2 over 8 experts drop most
    assignments: a token whose every assignment was dropped gets y = 0
    (and the shared expert alone in deepseek), as in the reference."""
    jc, tc = configs("granite-moe-3b-a800m", capacity_factor=0.05)
    jp, tp = moe_params(jc, tc, seed=2)
    x = np.random.default_rng(3).normal(size=(1, 200, tc.d_model)).astype(
        np.float32)
    r = tmoe.moe_route(tp, tc, t(x[0]))
    assert r.cap == 8 and int(r.keep.sum()) <= 8 * tc.n_experts
    kept_tokens = set((r.order[r.keep] // tc.top_k).tolist())
    got, _ = tmoe.moe_apply(tp, tc, t(x))
    want, _ = jmoe.moe_apply(jp, jc, j(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dropped = sorted(set(range(200)) - kept_tokens)
    assert dropped and not got[0, dropped].any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_combine_is_the_references_scatter_add_bit_for_bit(dtype):
    """``combine`` adds each token's k contributions in sorted-slot order,
    rounding after each add: bit for bit the reference's
    ``zeros.at[token_of].add(...)`` on the same contributions (bf16 rounds
    at every add, so a different order would show)."""
    rng = np.random.default_rng(11)
    t_, k, d = 50, 6, 16
    topi = np.stack([rng.permutation(64)[:k] for _ in range(t_)])
    flat = topi.reshape(-1)
    order = np.argsort(flat, kind="stable")
    contrib = rng.normal(size=(t_ * k, d)).astype(np.float32) * \
        rng.choice([1e-3, 1.0, 1e3], size=(t_ * k, 1)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jnp.zeros((t_, d), jdt).at[j(order // k)].add(
        j(contrib).astype(jdt))
    got = tmoe.combine(t(contrib).to(tdt), t(order), k)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_bf16_moe_layer_is_repeatable():
    """bf16 activations: two calls on the same input give the same bits
    (no atomics anywhere in dispatch or combine)."""
    _, tc = configs("deepseek-v2-lite-16b", dtype="bfloat16")
    _, tp = moe_params(*configs("deepseek-v2-lite-16b"), seed=4)
    x = t(np.random.default_rng(5).normal(size=(2, 24, tc.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    a, aux_a = tmoe.moe_apply(tp, tc, x)
    b, aux_b = tmoe.moe_apply(tp, tc, x)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert torch.equal(aux_a, aux_b)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mla():
    jc, tc = configs("deepseek-v2-lite-16b")
    jp = jmla.mla_init(jax.random.PRNGKey(7), jc, jnp.float32)
    return jc, tc, jp, params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                         "cpu")


def test_mla_naive_path_matches_jax(mla):
    jc, tc, jp, tp = mla
    x = np.random.default_rng(8).normal(size=(2, 11, tc.d_model)).astype(
        np.float32)
    pos = np.arange(11, dtype=np.int32)
    want, cache = jmla.mla_apply(jp, jc, j(x), j(pos))
    got = tmla.mla_apply(tp, tc, t(x), t(pos))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("prompt", [7, 1])
def test_mla_absorbed_path_prefill_then_decode_matches_jax(mla, prompt):
    """A prefill of ``prompt`` tokens into a 16-slot compressed cache, then
    three one-token steps, on the absorbed path: outputs and the cache
    (c_kv, k_rope) against the reference's."""
    jc, tc, jp, tp = mla
    rng = np.random.default_rng(9)
    spec = jmla.mla_cache_spec(jc, 2, 16, jnp.float32)
    jcache = {k: jnp.zeros(s.shape, s.dtype) for k, s in spec.items()}
    tspec = tmla.mla_cache_spec(tc, 2, 16, torch.float32)
    tcache = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt)
              in tspec.items()}
    assert {k: v.shape for k, v in tcache.items()} == \
        {k: s.shape for k, s in spec.items()}
    offset = 0
    for s in (prompt, 1, 1, 1):
        x = rng.normal(size=(2, s, tc.d_model)).astype(np.float32)
        pos = np.arange(s, dtype=np.int32) + offset
        want, new = jmla.mla_apply(jp, jc, j(x), j(pos),
                                   dict(jcache, offset=offset))
        got = tmla.mla_apply(tp, tc, t(x), t(pos),
                             dict(tcache, offset=offset))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        jcache = new
        offset += s
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   **TOL)


def test_mla_absorbed_prefill_equals_the_naive_path(mla):
    """Same math: the absorbed path into an empty cache gives the naive
    path's output (the reference's equivalence, held in the port)."""
    _, tc, _, tp = mla
    x = t(np.random.default_rng(10).normal(size=(2, 9, tc.d_model)).astype(
        np.float32))
    pos = torch.arange(9, dtype=torch.int32)
    cache = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in
             tmla.mla_cache_spec(tc, 2, 12, torch.float32).items()}
    got = tmla.mla_apply(tp, tc, x, pos, dict(cache, offset=0))
    np.testing.assert_allclose(got.numpy(),
                               tmla.mla_apply(tp, tc, x, pos).numpy(), **TOL)


def test_mla_cache_overflow_raises(mla):
    _, tc, _, tp = mla
    cache = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in
             tmla.mla_cache_spec(tc, 1, 4, torch.float32).items()}
    with pytest.raises(ValueError, match="does not fit"):
        tmla.mla_apply(tp, tc, torch.zeros((1, 5, tc.d_model)),
                       torch.arange(5), dict(cache, offset=0))


# ---------------------------------------------------------------------------
# sdpa_chunked
# ---------------------------------------------------------------------------
CHUNKED_CASES = [
    # (sq, sk, hq, hkv, causal, chunk)
    (32, 32, 4, 2, True, 8),
    (32, 32, 4, 2, False, 8),
    (24, 24, 6, 2, True, 24),
    (16, 16, 4, 4, False, 64),       # chunk > sk: one block
    (8, 32, 4, 1, False, 16),        # fewer queries than keys
]


@pytest.mark.parametrize("case", CHUNKED_CASES)
def test_sdpa_chunked_matches_jax_and_sdpa(case):
    sq, sk, hq, hkv, causal, chunk = case
    rng = np.random.default_rng(sq + sk + hq)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((2, sq, hq, 16), (2, sk, hkv, 16), (2, sk, hkv, 16)))
    got = tl.sdpa_chunked(t(q), t(k), t(v), causal=causal, chunk=chunk)
    want = jl.sdpa_chunked(j(q), j(k), j(v), causal=causal, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), tl.sdpa(t(q), t(k), t(v), causal=causal).numpy(), **TOL)


def test_sdpa_chunked_keeps_the_input_type_and_refuses_a_ragged_tail():
    q = torch.randn(1, 12, 2, 8, generator=torch.Generator().manual_seed(0))
    out = tl.sdpa_chunked(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                          causal=True, chunk=4)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    with pytest.raises(AssertionError):
        tl.sdpa_chunked(q, q, q, causal=True, chunk=5)
