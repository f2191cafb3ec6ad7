"""The seven transformer configurations the port took over in one slice
(qwen1.5-0.5b, qwen2-7b, gemma-7b, granite-moe-3b-a800m,
deepseek-v2-lite-16b, hubert-xlarge, pixtral-12b) against the JAX
package's, on the CPU.

Each runs reduced (``cfg.reduced()``: 2 layers, d_model 128; deepseek's
first layer dense) with the JAX model's parameters carried across by
``params_from_numpy``. Logits and caches agree within rtol 1e-4 / atol
1e-5 (the repo's float32 band); the MoE aux loss too; generated tokens
are exact. The full-width parameter counts come from the JAX package's
shapes (``jax.eval_shape``); the port's shapes equal JAX's at the reduced
size, where they are cheap to make.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_config as j_get_config
from repro.configs.base import shape_applicable as j_shape_applicable
from repro.models.registry import get_model as j_get_model
from repro.models.registry import input_specs as j_input_specs
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import make_encode_step as j_make_encode_step
from repro_torch.configs import ARCH_IDS
from repro_torch.configs.base import SHAPES, get_config, shape_applicable
from repro_torch.launch import serve
from repro_torch.models.registry import (get_model, input_specs,
                                         params_from_numpy, params_to_numpy)
from repro_torch.serving.engine import ServingEngine, make_encode_step

TOL = dict(rtol=1e-4, atol=1e-5)

# full-width parameter counts (float32 parameters)
FULL_COUNTS = {
    "deepseek-v2-lite-16b": 15_706_484_224,
    "pixtral-12b": 12_253_025_280,
    "gemma-7b": 8_537_680_896,
    "qwen2-7b": 7_615_616_512,
    "granite-moe-3b-a800m": 3_298_793_472,
    "hubert-xlarge": 945_973_760,
    "qwen1.5-0.5b": 463_987_712,
}
NAMES = sorted(FULL_COUNTS)
DECODERS = [n for n in NAMES if n != "hubert-xlarge"]
_CARRIED = {}


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(x)


def carried(name):
    """Reduced JAX model and params, and the port's with the same params
    (made once per config in this module)."""
    if name not in _CARRIED:
        jc = j_get_config(name).reduced()
        tc = get_config(name).reduced()
        jm = j_get_model(jc)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = get_model(tc)
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
        _CARRIED[name] = jm, jp, tm, tp
    return _CARRIED[name]


def inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "frames":
        return {"embeds": rng.normal(size=(b, s, cfg.frontend_dim)).astype(
            np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}


# ---------------------------------------------------------------------------
# configs, shapes, parameters
# ---------------------------------------------------------------------------
def test_every_config_of_the_family_is_ported():
    # the SSM and hybrid configs are held by tests/test_torch_ssm.py
    assert sorted(ARCH_IDS) == sorted([*NAMES, "qwen2-0.5b", "xlstm-125m",
                                       "zamba2-1.2b"])
    assert ARCH_IDS == __import__(
        "repro.configs", fromlist=["ARCH_IDS"]).ARCH_IDS


@pytest.mark.parametrize("name", NAMES)
def test_config_copy_equals_the_jax_config(name):
    jc, tc = j_get_config(name), get_config(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(
        jc.reduced())
    for shape in J_SHAPES:
        assert shape_applicable(tc, shape) == j_shape_applicable(jc, shape)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_match_jax(name, shape):
    jc, tc = j_get_config(name), get_config(name)
    want = j_input_specs(jc, J_SHAPES[shape])
    got = input_specs(tc, SHAPES[shape])
    assert got.keys() == want.keys()
    for k, (shp, dt) in got.items():
        assert shp == want[k].shape
        assert str(dt).removeprefix("torch.") == str(want[k].dtype)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_tree_and_full_width_count(name):
    """The port's init gives the JAX init's tree (nesting, the list of
    first blocks, shapes) at the reduced size; the full-width count from
    the JAX shapes is the one the port's chip run checks."""
    jm, _, tm, _ = carried(name)
    jtree = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    ttree = params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(ttree) == jax.tree.structure(jtree)
    assert [x.shape for x in jax.tree.leaves(ttree)] == \
        [x.shape for x in jax.tree.leaves(jtree)]
    full = jax.eval_shape(j_get_model(j_get_config(name)).init,
                          jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full)) == \
        FULL_COUNTS[name]


@pytest.mark.parametrize("name", NAMES)
def test_params_round_trip(name):
    _, jp, _, tp = carried(name)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# forward, cache, engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_cacheless_forward_matches_jax(name, use_kernels):
    """Logits and the MoE aux loss (summed over the stacked layers, divided
    by n_layers); on the CPU both settings take the plain versions."""
    jm, jp, tm, tp = carried(name)
    batch = inputs(tm.cfg, 2, 16, 0)
    want, _, want_aux = jm.apply(jp, jax.tree.map(j, batch))
    got, cache, aux = tm.apply(tp, jax.tree.map(t, batch),
                               use_kernels=use_kernels)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux["moe_aux"]),
                               float(want_aux["moe_aux"]), **TOL)
    assert (float(aux["moe_aux"]) > 0) == (tm.cfg.n_experts > 0)


@pytest.mark.parametrize("name", DECODERS)
def test_prefill_then_decode_with_cache_matches_jax(name):
    """Prefill 12 tokens into a float32 cache of 32 slots, then three
    one-token steps (K5's plain version in GQA configs, the absorbed MLA
    path in deepseek); logits and every cache tensor against JAX's."""
    jm, jp, tm, tp = carried(name)
    rng = np.random.default_rng(1)
    spec = jm.cache_spec(2, 32, jnp.float32)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), spec)
    tcache = tm.new_cache(2, 32, torch.float32, "cpu")
    for step in range(4):
        tok = rng.integers(0, tm.cfg.vocab_size,
                           (2, 12 if step == 0 else 1)).astype(np.int32)
        want, jcache, _ = jm.apply(jp, {"tokens": j(tok)}, jcache)
        got, tcache, _ = tm.apply(tp, {"tokens": t(tok)}, tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert tcache["offset"] == int(jcache["offset"])
    jflat = dict(jcache["layers"])
    for i, first in enumerate(jcache.get("first", [])):
        jflat.update({f"first{i}.{k}": v for k, v in first.items()})
    tflat = {k: v for k, v in tcache.items() if k not in ("first",
                                                         "offset")}
    for i, first in enumerate(tcache.get("first", [])):
        tflat.update({f"first{i}.{k}": v for k, v in first.items()})
    assert tflat.keys() == jflat.keys()
    for k, v in tflat.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jflat[k]), **TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", DECODERS)
def test_generate_gives_the_jax_engines_tokens(name):
    jm, jp, tm, tp = carried(name)
    kw = dict(max_cache_len=64, batch_buckets=(2, 4), seq_buckets=(16,))
    je = JEngine(jm, jp, cache_dtype=jnp.float32, **kw)
    te = ServingEngine(tm, tp, cache_dtype=torch.float32, **kw)
    tok = np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (3, 10)).astype(np.int32)
    want = np.asarray(je.generate(j(tok), steps=5))
    got = te.generate(t(tok), steps=5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert te.stats == je.stats


@pytest.mark.parametrize("masked", [False, True])
def test_hubert_encode_matches_jax(masked):
    """hubert-xlarge (bidirectional, frames frontend) through
    ``make_encode_step``, with and without HuBERT's mask."""
    jm, jp, tm, tp = carried("hubert-xlarge")
    batch = inputs(tm.cfg, 2, 16, 3)
    if masked:
        batch["mask"] = np.random.default_rng(4).random((2, 16)) < 0.4
    want = j_make_encode_step(jm)(jp, jax.tree.map(j, batch))
    got = make_encode_step(tm)(tp, jax.tree.map(t, batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:   # the mask embedding changed the masked frames' logits
        plain = make_encode_step(tm)(tp, {"embeds": t(batch["embeds"])})
        assert not torch.allclose(got, plain)


def test_pixtral_prefill_with_patches_matches_jax():
    """Patch embeddings replace the first n_patches positions, cache-less
    and in the engine's prefill into the cache."""
    jm, jp, tm, tp = carried("pixtral-12b")
    cfg = tm.cfg
    batch = inputs(cfg, 2, 16, 5)
    batch["patches"] = np.random.default_rng(6).normal(
        size=(2, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    want, _, _ = jm.apply(jp, jax.tree.map(j, batch))
    got, _, _ = tm.apply(tp, jax.tree.map(t, batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain, _, _ = tm.apply(tp, {"tokens": t(batch["tokens"])})
    assert not torch.allclose(got[:, :cfg.n_patches],
                              plain[:, :cfg.n_patches])
    kw = dict(max_cache_len=32, batch_buckets=(2,), seq_buckets=(16,))
    je = JEngine(jm, jp, cache_dtype=jnp.float32, **kw)
    te = ServingEngine(tm, tp, cache_dtype=torch.float32, **kw)
    wl, _, _ = je.prefill(j(batch["tokens"]),
                          extra={"patches": j(batch["patches"])})
    gl, _, _ = te.prefill(t(batch["tokens"]),
                          extra={"patches": t(batch["patches"])})
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "granite-moe-3b-a800m"])
def test_serve_launcher_runs_the_moe_configs_on_the_cpu(name, capsys):
    summ, engine = serve.main(["--device", "cpu", "--reduced", "--arch",
                               name, "--replicas", "2", "--episodes", "2"],
                              return_engine=True)
    for key in ("reward", "effective_throughput", "latency", "bs",
                "generate_s"):
        assert summ[key].shape == (2,) and np.isfinite(summ[key]).all()
    out = capsys.readouterr().out
    assert out.startswith(f"{name} (reduced): 2 layers, d_model 128")
    assert out.rstrip().endswith("done")
    # the engine that served, for a caller measuring it further
    assert engine.model.cfg.name == name
    assert engine.generate(np.zeros((2, 16), np.int32), steps=2).shape == (
        2, 2)


def test_serve_launcher_refuses_an_encoder(capsys):
    """hubert-xlarge has no decode step (``shape_applicable`` skips
    ``decode_32k``): ``serve`` refuses it before building anything."""
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--reduced", "--arch",
                    "hubert-xlarge"])
    assert "encoder-only" in capsys.readouterr().err
