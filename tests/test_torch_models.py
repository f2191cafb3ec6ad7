"""The port's LM model (``repro_torch.models``, ``repro_torch.configs.base``)
against the JAX package's (``repro.models``, ``repro.configs``), on the CPU,
from the same numpy inputs and the same parameters carried across by
``params_from_numpy``.

Tolerances: layers rtol 1e-5 / atol 1e-6 (float32 roundoff of one op
chain); a 2-layer reduced qwen2-0.5b's logits rtol 1e-4 / atol 1e-5 (the
repo's float32 band).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import layers as jl
from repro.models.registry import get_model as j_get_model
from repro_torch.configs import base as tbase
from repro_torch.models import layers as tl
from repro_torch.models.registry import (get_model, params_from_numpy,
                                         params_to_numpy)

LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(x)


def reduced(n_layers=2, **kw):
    """The same reduced qwen2-0.5b in both packages."""
    jc = j_get_config("qwen2-0.5b").reduced().replace(n_layers=n_layers, **kw)
    tc = tbase.get_config("qwen2-0.5b").reduced().replace(n_layers=n_layers,
                                                          **kw)
    return jc, tc


@pytest.fixture(scope="module")
def carried():
    """A 2-layer reduced qwen2-0.5b: JAX model and params, and the port's
    model with the same params carried across."""
    jc, tc = reduced()
    jm = j_get_model(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(tc)
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_config_copy_equals_the_jax_config():
    jc = j_get_config("qwen2-0.5b")
    tc = tbase.get_config("qwen2-0.5b")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    assert (tc.q_dim, tc.kv_dim) == (jc.q_dim, jc.kv_dim) == (896, 128)
    assert tbase.list_archs() == [
        "deepseek-v2-lite-16b", "gemma-7b", "granite-moe-3b-a800m",
        "hubert-xlarge", "pixtral-12b", "qwen1.5-0.5b", "qwen2-0.5b",
        "qwen2-7b", "xlstm-125m", "zamba2-1.2b"]
    assert tbase.SHAPES.keys() == __import__(
        "repro.configs.base", fromlist=["SHAPES"]).SHAPES.keys()


def test_full_width_parameter_count():
    """qwen2-0.5b at full width: 494,032,768 parameters; the port's init
    gives the JAX init's tree of shapes (compared at reduced size, where it
    is cheap, and counted at full size from the JAX shapes)."""
    jc, tc = reduced()
    jtree = jax.eval_shape(j_get_model(jc).init, jax.random.PRNGKey(0))
    ttree = get_model(tc).init(torch.Generator().manual_seed(0))
    assert jax.tree.structure(ttree) == jax.tree.structure(jtree)
    assert [tuple(x.shape) for x in jax.tree.leaves(ttree)] == \
        [x.shape for x in jax.tree.leaves(jtree)]
    full = jax.eval_shape(j_get_model(j_get_config("qwen2-0.5b")).init,
                          jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full)) \
        == 494_032_768


@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-1.2b"])
def test_other_architectures_raise_not_implemented(name):
    """The SSM and hybrid configs were the last the port lacked: they are
    registered now, nothing is left in ``NOT_PORTED``, and an unknown name
    still raises."""
    assert tbase.NOT_PORTED == {}
    assert tbase.get_config(name).name == name
    with pytest.raises(KeyError):
        tbase.get_config("no-such-arch")


@pytest.mark.parametrize("kw", [dict(family="ssm"), dict(family="hybrid"),
                                dict(shard_activations=True)])
def test_unported_model_features_raise(kw):
    """Activation sharding hints are not ported, in any family; the ssm
    and hybrid families build their own assemblies."""
    _, tc = reduced(**kw)
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        get_model(tc.replace(shard_activations=True))
    if "family" in kw:
        model = get_model(tc.replace(n_layers=2, slstm_every=2,
                                     attn_every=2, ssm_state=16,
                                     ssm_head_dim=32, ssm_chunk=32))
        params = model.init(torch.Generator().manual_seed(0))
        assert ("mamba" in params) == (kw["family"] == "hybrid")
        assert ("blocks" in params and isinstance(params["blocks"], list)) \
            == (kw["family"] == "ssm")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rmsnorm_and_layernorm_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    g = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(tl.rmsnorm({"g": t(g)}, t(x)).numpy(),
                               np.asarray(jl.rmsnorm({"g": j(g)}, j(x))),
                               **LAYER_TOL)
    np.testing.assert_allclose(
        tl.layernorm({"g": t(g), "b": t(b)}, t(x)).numpy(),
        np.asarray(jl.layernorm({"g": j(g), "b": j(b)}, j(x))), **LAYER_TOL)


@pytest.mark.parametrize("theta,d", [(1e6, 64), (1e4, 32)])
def test_rope_matches(theta, d):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 17, 3, d)).astype(np.float32)
    pos = (np.arange(17, dtype=np.int32) + 40)
    np.testing.assert_allclose(tl.rope_frequencies(d, theta).numpy(),
                               np.asarray(jl.rope_frequencies(d, theta)),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tl.apply_rope(t(x), t(pos), theta).numpy(),
                               np.asarray(jl.apply_rope(j(x), j(pos), theta)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False)])
def test_mlp_matches(act, gated):
    rng = np.random.default_rng(2)
    p = {"gate": {"w": rng.normal(size=(32, 48)) / 6},
         "down": {"w": rng.normal(size=(48, 32)) / 7}}
    if gated:
        p["up"] = {"w": rng.normal(size=(32, 48)) / 6}
    p = {k: {"w": v["w"].astype(np.float32)} for k, v in p.items()}
    x = rng.normal(size=(3, 32)).astype(np.float32)
    got = tl.mlp(jax.tree.map(t, p), t(x), act)
    want = jl.mlp(jax.tree.map(j, p), j(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_embed_unembed_repeat_kv_match():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    tok = rng.integers(0, 50, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        tl.embed({"table": t(table)}, t(tok), 4.0).numpy(),
        np.asarray(jl.embed({"table": j(table)}, j(tok), 4.0)))
    x = rng.normal(size=(2, 7, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tl.unembed({"table": t(table)}, t(x)).numpy(),
        np.asarray(jl.unembed({"table": j(table)}, j(x))), **LAYER_TOL)
    k = rng.normal(size=(2, 5, 2, 8)).astype(np.float32)
    np.testing.assert_array_equal(tl.repeat_kv(t(k), 3).numpy(),
                                  np.asarray(jl.repeat_kv(j(k), 3)))


SDPA_CASES = [
    # (sq, sk, hq, hkv, kwargs)
    (9, 9, 4, 2, dict(causal=True)),
    (9, 9, 4, 4, dict(causal=False)),
    (3, 20, 4, 2, dict(causal=True, q_offset=6, kv_len=9)),
    (1, 20, 6, 2, dict(causal=True, q_offset=12, kv_len=13)),
    (9, 9, 4, 2, dict(causal=True, softcap=5.0)),
    (9, 9, 4, 2, dict(causal=True, gqa_impl="grouped")),
    (3, 20, 6, 2, dict(causal=True, q_offset=6, kv_len=9,
                       gqa_impl="grouped", softcap=3.0)),
]


@pytest.mark.parametrize("case", SDPA_CASES)
def test_sdpa_matches(case):
    sq, sk, hq, hkv, kw = case
    rng = np.random.default_rng(sq * 100 + sk)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((2, sq, hq, 16), (2, sk, hkv, 16), (2, sk, hkv, 16)))
    got = tl.sdpa(t(q), t(k), t(v), **kw)
    want = jl.sdpa(j(q), j(k), j(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_sdpa_per_row_kv_len_matches():
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((3, 1, 4, 16), (3, 12, 2, 16), (3, 12, 2, 16)))
    lens = np.array([1, 7, 12], np.int32)
    got = tl.sdpa(t(q), t(k), t(v), causal=False, kv_len=t(lens))
    want = jl.sdpa(j(q), j(k), j(v), causal=False, kv_len=j(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_softcap_in_the_kernel_path_raises():
    _, tc = reduced(logit_softcap=30.0)
    gen = torch.Generator().manual_seed(0)
    model = get_model(tc)
    params = model.init(gen)
    tok = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="softcap"):
        model.apply(params, tok, use_kernels=True)
    logits, _, _ = model.apply(params, tok, use_kernels=False)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_model_matches_jax(causal):
    """``attn_impl="chunked"`` (``sdpa_chunked``, 8-token blocks) in a
    cache-less forward without kernels, against the JAX model's."""
    jc, tc = reduced(attn_impl="chunked", attn_chunk=8, causal=causal)
    jm = j_get_model(jc)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = get_model(tc)
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(5).integers(
        0, tc.vocab_size, (2, 24)).astype(np.int32)
    want, _, _ = jm.apply(jp, {"tokens": j(tok)})
    got, _, _ = tm.apply(tp, {"tokens": t(tok)}, use_kernels=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


# ---------------------------------------------------------------------------
# the model: parameters carried across, cache-less and cached
# ---------------------------------------------------------------------------
def test_params_round_trip(carried):
    jm, jp, tm, tp = carried
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_cacheless_forward_matches_jax(carried, use_kernels):
    jm, jp, tm, tp = carried
    tok = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _, _ = jm.apply(jp, {"tokens": j(tok)})
    got, cache, aux = tm.apply(tp, {"tokens": t(tok)},
                               use_kernels=use_kernels)
    assert cache is None and float(aux["moe_aux"]) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_then_decode_with_cache_matches_jax(carried, use_kernels):
    """Prefill 12 tokens into a float32 cache of 32 slots, then three
    one-token steps; logits and the cache against the JAX model's."""
    jm, jp, tm, tp = carried
    rng = np.random.default_rng(1)
    tok = rng.integers(0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    spec = jm.cache_spec(2, 32, jnp.float32)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), spec)
    tcache = tm.new_cache(2, 32, torch.float32, "cpu")
    assert tuple(tcache["k"].shape) == spec["layers"]["k"].shape
    for step in range(4):
        batch = tok if step == 0 else rng.integers(
            0, tm.cfg.vocab_size, (2, 1)).astype(np.int32)
        want, jcache, _ = jm.apply(jp, {"tokens": j(batch)}, jcache)
        got, tcache, _ = tm.apply(tp, {"tokens": t(batch)}, tcache,
                                  use_kernels=use_kernels)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        assert tcache["offset"] == int(jcache["offset"])
    np.testing.assert_allclose(tcache["k"].numpy(),
                               np.asarray(jcache["layers"]["k"]), **MODEL_TOL)


def test_cache_overflow_raises(carried):
    _, _, tm, tp = carried
    cache = tm.new_cache(1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        tm.apply(tp, {"tokens": torch.zeros((1, 9), dtype=torch.int32)},
                 cache)
