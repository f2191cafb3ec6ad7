"""The SSM and hybrid families of the port (``models/ssm.py``,
``models/hybrid.py``: zamba2-1.2b and xlstm-125m) against the JAX
package's, on the CPU.

Each runs reduced (``cfg.reduced()``: zamba2 5 layers as 2 groups of 2
plus one trailing Mamba layer, chunk 32; xlstm 4 layers with sLSTM at 0
and 2, chunk 128; d_model 128) in float32 with the JAX model's parameters
carried across by ``params_from_numpy``, inputs made from a seed with
numpy. The mLSTM block tests take a chunk of 32, so that 64 tokens are two
chunks.

Tolerances. A block alone (Mamba2 chunked and stepped, the three mLSTM
forms, sLSTM) agrees within the repo's band, rtol 1e-4 / atol 1e-5. A
whole model is held at rtol 1e-4 / atol 1e-4 (``MODEL_TOL``): the blocks'
exp-stabilized forms (the SSD's exp(cumsum) decay matrices, mLSTM's
running max) sum in another order than XLA's fused scans, each block
leaves ~1e-5 of float32 roundoff, and four or five of them through the
residual stream put up to 4.5e-5 on logits of magnitude ~4 (measured
over three seeds). Generated tokens are exact; cache offsets and shapes
exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.models import ssm as jssm
from repro.models.registry import get_model as j_get_model
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs.base import get_config
from repro_torch.launch import serve
from repro_torch.models import hybrid
from repro_torch.models import ssm as tssm
from repro_torch.models.registry import (get_model, params_from_numpy,
                                         params_to_numpy)
from repro_torch.serving.engine import ServingEngine

TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ["xlstm-125m", "zamba2-1.2b"]
# full-width parameter counts (float32 parameters), from the JAX shapes
FULL_COUNTS = {"zamba2-1.2b": 1_104_937_856, "xlstm-125m": 113_922_896}
_CARRIED = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def j(x):
    return jnp.asarray(x)


def carried(name):
    """Reduced JAX model (apply jitted) and params, and the port's with the
    same params (made once per config in this module)."""
    if name not in _CARRIED:
        jc, tc = j_get_config(name).reduced(), get_config(name).reduced()
        jm = j_get_model(jc)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        tm = get_model(tc)
        tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
        _CARRIED[name] = jm, jax.jit(jm.apply), jp, tm, tp
    return _CARRIED[name]


def tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def jit(fn, **kw):
    """A JAX block function jitted on its config (the second argument):
    one compile a shape instead of one a dispatched op."""
    return jax.jit(fn, static_argnums=1, **kw)


def block_params(init, cfg, seed=0):
    """A JAX block's params and the port's copy of them."""
    jp = init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return jp, jax.tree.map(t, jp)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_config_copy_and_parameter_tree(name):
    """The config (full and reduced) equals JAX's field for field, the SSM
    fields included; the port's init gives JAX's tree of shapes at the
    reduced size, the params carry both ways, and the full-width count
    from the JAX shapes is the one the chip run checks."""
    jc, tc = j_get_config(name), get_config(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(
        jc.reduced())
    for c in (tc, tc.reduced()):
        jr = jc if c is tc else jc.reduced()
        assert (c.d_inner, c.ssm_n_heads) == (jr.d_inner, jr.ssm_n_heads)
    assert tc.reduced().ssm_chunk == (32 if tc.ssm_state else 128)
    jm, _, jp, tm, tp = carried(name)
    jtree = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    ttree = params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(ttree) == jax.tree.structure(jtree)
    assert [x.shape for x in jax.tree.leaves(ttree)] == \
        [x.shape for x in jax.tree.leaves(jtree)]
    back = params_to_numpy(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    full = jax.eval_shape(j_get_model(jc).init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full)) == \
        FULL_COUNTS[name]


@pytest.mark.parametrize("name", NAMES)
def test_cache_layout_matches_jax(name):
    """``new_cache`` against JAX's ``cache_spec``: every tensor's shape and
    dtype (bf16 and float32 caches); offset a host int 0. zamba2 at full
    width: 6 stacked KV caches and 38 Mamba states."""
    jm, _, _, tm, _ = carried(name)
    full = get_model(get_config(name))
    jfull = j_get_model(j_get_config(name))
    for model, jmodel, b, n in ((tm, jm, 2, 32), (full, jfull, 1, 8)):
        for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                         (torch.float32, jnp.float32)):
            cache = model.new_cache(b, n, tdt, "meta")
            spec = jmodel.cache_spec(b, n, jdt)
            assert cache.pop("offset") == 0 and spec.pop("offset").shape == ()
            got = jax.tree.leaves(jax.tree.map(
                lambda x: (tuple(x.shape), str(x.dtype).split(".")[-1]),
                cache), is_leaf=lambda x: isinstance(x, tuple))
            want = jax.tree.leaves(jax.tree.map(
                lambda s: (s.shape, str(s.dtype)), spec),
                is_leaf=lambda x: isinstance(x, tuple))
            assert jax.tree.structure(jax.tree.map(lambda x: 0, cache)) == \
                jax.tree.structure(jax.tree.map(lambda x: 0, spec))
            assert got == want
    if name == "zamba2-1.2b":
        zc = full.new_cache(1, 8, torch.bfloat16, "meta")
        assert zc["attn"]["k"].shape[0] == 6
        assert zc["mamba"]["h"].shape[0] == 38


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,with_state", [(64, True), (40, False),
                                          (16, True)])
def test_mamba2_chunked_matches_jax(s, with_state):
    """The chunked SSD (two chunks of 32; a padded length; one short
    chunk), its output and, as a prefill, the final state and conv
    tail."""
    cfg = get_config("zamba2-1.2b").reduced()
    jp, tp = block_params(jssm.mamba2_init, cfg)
    u = np.random.default_rng(s).normal(size=(2, s, 128)).astype(np.float32)
    jcache = tcache = None
    if with_state:
        spec = jssm.mamba2_cache_spec(cfg, 2, jnp.float32)
        jcache = jax.tree.map(lambda x: jnp.zeros(x.shape, x.dtype), spec)
        tcache = jax.tree.map(lambda x: t(np.asarray(x)), jcache)
    want, wst = jit(jssm.mamba2_apply)(jp, cfg, j(u), jcache)
    got, gst = tssm.mamba2_apply(tp, cfg, t(u), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (gst is None) == (wst is None) == (not with_state)
    if with_state:
        for k in ("h", "conv"):
            np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]),
                                       **TOL, err_msg=k)


def test_mamba2_chunked_equals_its_step_decode():
    """Decoding token by token from the empty state gives the chunked
    form's outputs and its final state (both forms of the port, and the
    steps against JAX's)."""
    cfg = get_config("zamba2-1.2b").reduced()
    jp, tp = block_params(jssm.mamba2_init, cfg, seed=1)
    u = np.random.default_rng(7).normal(size=(2, 32, 128)).astype(
        np.float32)
    spec = tssm.mamba2_cache_spec(cfg, 2, torch.float32)
    zeros = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in
             spec.items()}
    full, fst = tssm.mamba2_apply(tp, cfg, t(u), zeros)
    cache, jcache = zeros, jax.tree.map(lambda x: j(x.numpy()), zeros)
    jstep = jit(jssm.mamba2_apply)
    for i in range(u.shape[1]):
        y, cache = tssm.mamba2_apply(tp, cfg, t(u[:, i:i + 1]), cache)
        wy, jcache = jstep(jp, cfg, j(u[:, i:i + 1]), jcache)
        np.testing.assert_allclose(y.numpy(), full[:, i:i + 1].numpy(),
                                   **TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(cache["h"].numpy(), fst["h"].numpy(), **TOL)
    np.testing.assert_allclose(cache["conv"].numpy(), fst["conv"].numpy(),
                               **TOL)


def test_mamba2_gradient_stays_finite_at_a_full_chunk():
    """At a chunk of 128 (zamba2's full width) the SSD's upper-triangle
    decays exp(a_cum[l] - a_cum[s]), l < s, overflow float32. The
    reference masks after the exp, so its gradient is 0 * inf = NaN
    there; the port masks before it (ROADMAP queue 3): the same forward
    (within ``MODEL_TOL``: a cumsum 128 long, 2.3e-5 measured), a finite
    gradient."""
    cfg = get_config("zamba2-1.2b").reduced().replace(ssm_chunk=128)
    jp, _ = block_params(jssm.mamba2_init, cfg, seed=3)
    u = np.random.default_rng(8).normal(size=(1, 128, 128)).astype(
        np.float32)
    jgrad = jax.jit(jax.grad(lambda p: jssm.mamba2_apply(p, cfg, j(u))[0]
                             .sum()))(jp)
    assert not all(bool(jnp.isfinite(x).all())
                   for x in jax.tree.leaves(jgrad))
    tp = jax.tree.map(lambda x: t(x).requires_grad_(True), jp)
    out, _ = tssm.mamba2_apply(tp, cfg, t(u))
    want, _ = jit(jssm.mamba2_apply)(jp, cfg, j(u))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **MODEL_TOL)
    grads = torch.autograd.grad(out.sum(), jax.tree.leaves(tp))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("form", ["parallel", "chunkwise", "step"])
def test_mlstm_forms_match_jax(form):
    """``_mlstm_parallel`` (16 tokens), ``_mlstm_chunkwise`` (64 tokens in
    two chunks, with the final (C, n, m)) and ``_mlstm_step`` (four steps
    from that state) against JAX's; the chunkwise form equals the
    parallel one."""
    cfg = get_config("xlstm-125m").reduced().replace(ssm_chunk=32)
    jp, tp = block_params(jssm.mlstm_init, cfg, seed=2)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64 if form != "parallel" else 16, 128)).astype(
        np.float32)
    if form == "parallel":
        want = jit(jssm._mlstm_parallel)(jp, cfg, j(x))
        got = tssm._mlstm_parallel(tp, cfg, t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    want, wst = jit(jssm._mlstm_chunkwise, static_argnames="return_state")(
        jp, cfg, j(x), return_state=True)
    got, gst = tssm._mlstm_chunkwise(tp, cfg, t(x), return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), tssm._mlstm_parallel(tp, cfg, t(x)).numpy(), **TOL)
    for g, w in zip(gst, wst):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if form == "step":
        gc = dict(zip("Cnm", gst))
        wc = dict(zip("Cnm", wst))
        jstep = jit(jssm.mlstm_apply)
        for i in range(4):
            xi = rng.normal(size=(2, 1, 128)).astype(np.float32)
            w, wc = jstep(jp, cfg, j(xi), wc)
            g, gc = tssm.mlstm_apply(tp, cfg, t(xi), gc)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        for k in "Cnm":
            np.testing.assert_allclose(gc[k].numpy(), np.asarray(wc[k]),
                                       **TOL, err_msg=k)


@pytest.mark.parametrize("with_cache", [False, True])
def test_slstm_matches_jax(with_cache):
    """The loop over time against ``lax.scan``: from zeros without a
    cache (n starts at 1e-6), and from a random state with one (the final
    state returned)."""
    cfg = get_config("xlstm-125m").reduced()
    jp, tp = block_params(jssm.slstm_init, cfg, seed=4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 24, 128)).astype(np.float32)
    cache = None
    if with_cache:
        cache = {k: rng.normal(size=(2, 4, 32)).astype(np.float32)
                 for k in ("c", "h", "m")}
        cache["n"] = rng.uniform(0.5, 2.0, (2, 4, 32)).astype(np.float32)
    want, wst = jit(jssm.slstm_apply)(jp, cfg, j(x), None if cache is None else
                                 jax.tree.map(j, cache))
    got, gst = tssm.slstm_apply(tp, cfg, t(x), None if cache is None else
                                jax.tree.map(t, cache))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (gst is None) == (not with_cache)
    if with_cache:
        for k in "cnhm":
            np.testing.assert_allclose(gst[k].numpy(), np.asarray(wst[k]),
                                       **TOL, err_msg=k)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_cacheless_forward_matches_jax(name, use_kernels):
    """Logits at 40 tokens (zamba2: a chunk and a padded one; xlstm:
    mLSTM's parallel form) and 136 (zamba2: four chunks and a padded one;
    xlstm: two chunks of 128, the second padded); zamba2's shared attention
    takes K4's plain version on the CPU under ``use_kernels``. moe_aux is
    0."""
    _, japply, jp, tm, tp = carried(name)
    for s in (40, 136):
        tok = tokens(tm.cfg, 2, s, s)
        want, _, want_aux = japply(jp, {"tokens": j(tok)})
        got, cache, aux = tm.apply(tp, {"tokens": t(tok)},
                                   use_kernels=use_kernels)
        assert cache is None and float(aux["moe_aux"]) == 0.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_with_cache_matches_jax(name):
    """Prefill 32 tokens into a float32 cache of 64 slots, then three
    one-token steps (zamba2: K5's plain version in the shared block);
    logits, the offset and every cache tensor against JAX's."""
    _, japply, jp, tm, tp = carried(name)
    jm = _CARRIED[name][0]
    rng = np.random.default_rng(1)
    spec = jm.cache_spec(2, 64, jnp.float32)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), spec)
    tcache = tm.new_cache(2, 64, torch.float32, "cpu")
    for step in range(4):
        tok = rng.integers(0, tm.cfg.vocab_size,
                           (2, 32 if step == 0 else 1)).astype(np.int32)
        want, jcache, _ = japply(jp, {"tokens": j(tok)}, jcache)
        got, tcache, _ = tm.apply(tp, {"tokens": t(tok)}, tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
        assert tcache["offset"] == int(jcache["offset"]) == 32 + step
    jflat = jax.tree_util.tree_flatten_with_path(
        {k: v for k, v in jcache.items() if k != "offset"})[0]
    tflat = jax.tree.leaves({k: v for k, v in tcache.items()
                             if k != "offset"})
    assert len(tflat) == len(jflat)
    for g, (path, w) in zip(tflat, jflat):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", NAMES)
def test_generate_gives_the_jax_engines_tokens(name):
    """``ServingEngine.generate`` with the engines' default bf16 cache: a
    prefill of a 32-token bucket (the chunk), then decode steps whose
    Mamba2 conv window widens to float32 after the first step in both
    packages; tokens exact, stats equal."""
    jm, _, jp, tm, tp = carried(name)
    kw = dict(max_cache_len=64, batch_buckets=(2, 4), seq_buckets=(32,))
    je = JEngine(jm, jp, **kw)
    te = ServingEngine(tm, tp, **kw)
    tok = tokens(tm.cfg, 3, 20, 2)
    want = np.asarray(je.generate(j(tok), steps=6))
    got = te.generate(t(tok), steps=6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert te.stats == je.stats


def test_remat_gives_the_same_gradients():
    """``remat`` (``torch.utils.checkpoint`` around each Mamba layer)
    recomputes in the backward pass and changes no gradient."""
    _, _, _, tm, tp = carried("zamba2-1.2b")
    tok = t(tokens(tm.cfg, 2, 32, 9))
    grads = []
    for remat in (False, True):
        leaves = [p.clone().requires_grad_(True)
                  for p in jax.tree.leaves(tp)]
        params = jax.tree.unflatten(jax.tree.structure(tp), leaves)
        logits, _, _ = tm.apply(params, {"tokens": tok}, remat=remat,
                                use_kernels=False)
        grads.append(torch.autograd.grad(logits.square().mean(), leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", NAMES)
def test_serve_launcher_runs_on_the_cpu(name, capsys):
    summ = serve.main(["--device", "cpu", "--reduced", "--arch", name,
                       "--replicas", "2", "--episodes", "2"])
    for key in ("reward", "effective_throughput", "latency", "bs",
                "generate_s"):
        assert summ[key].shape == (2,) and np.isfinite(summ[key]).all()
    out = capsys.readouterr().out
    layers = 5 if name == "zamba2-1.2b" else 4
    assert out.startswith(f"{name} (reduced): {layers} layers, d_model 128")
    assert out.rstrip().endswith("done")
    assert hybrid._xlstm_kinds(get_config("xlstm-125m"))[::8] == \
        ["slstm", "slstm"]
