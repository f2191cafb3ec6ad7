"""The port's serving side (``repro_torch.serving``, ``repro_torch.launch.serve``)
against the JAX package's, on the CPU.

The engines run a 2-layer reduced qwen2-0.5b with the same parameters
carried across (``params_from_numpy``): greedy generation gives the JAX
engine's tokens exactly, and the last logits agree within rtol 1e-4 /
atol 1e-5 (the repo's float32 band). The bucketing and oversize cases are
those of tests/test_system.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.core.env import default_env_params as j_default_env_params
from repro.models.registry import get_model as j_get_model
from repro.serving import slo as jslo
from repro.serving.engine import ServingEngine as JEngine
from repro_torch.configs.base import get_config
from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.fleet import fleet_init
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve
from repro_torch.models.registry import get_model, params_from_numpy
from repro_torch.serving import slo
from repro_torch.serving.engine import ServingEngine, _bucket

TOL = dict(rtol=1e-4, atol=1e-5)
BUCKETS = dict(max_cache_len=128, batch_buckets=(2, 4), seq_buckets=(16, 32))


@pytest.fixture(scope="module")
def models():
    jc = j_get_config("qwen2-0.5b").reduced().replace(n_layers=2,
                                                      vocab_size=128)
    tc = get_config("qwen2-0.5b").reduced().replace(n_layers=2,
                                                    vocab_size=128)
    jm = j_get_model(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = get_model(tc)
    tp = params_from_numpy(tc, jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def engines(models, cache="float32", use_kernels=True):
    jm, jp, tm, tp = models
    return (JEngine(jm, jp, cache_dtype=getattr(jnp, cache), **BUCKETS),
            ServingEngine(tm, tp, cache_dtype=getattr(torch, cache),
                          use_kernels=use_kernels, **BUCKETS))


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_generate_gives_the_jax_engines_tokens(models, cache, use_kernels):
    je, te = engines(models, cache, use_kernels)
    tok = np.random.default_rng(0).integers(0, 128, (3, 12)).astype(np.int32)
    want = np.asarray(je.generate(jnp.asarray(tok), steps=6))
    got = te.generate(torch.from_numpy(tok), steps=6)
    assert got.dtype == torch.int32 and got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert te.stats == je.stats


def test_decode_steps_take_the_decode_kernels_plain_version(models):
    """On the CPU the engine's decode step goes through the K5 wrapper (its
    plain version: no launch counted) and prefill through sdpa."""
    _, te = engines(models)
    fa, da = flash_attention.launches, decode_attention.launches
    te.generate(torch.zeros((2, 5), dtype=torch.int32), steps=3)
    assert (flash_attention.launches, decode_attention.launches) == (fa, da)


def test_prefill_logits_match_including_the_pad_slot(models):
    """The prefill step returns the logits at the bucket's last slot (a pad
    token when the prompt is shorter), as the JAX engine does."""
    je, te = engines(models)
    tok = np.random.default_rng(1).integers(0, 128, (3, 20)).astype(np.int32)
    want, _, jinfo = je.prefill(jnp.asarray(tok))
    got, cache, info = te.prefill(torch.from_numpy(tok))
    assert info["bucket"] == jinfo["bucket"] == (4, 32)
    assert got.shape == (3, 128) and cache["offset"] == 32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert te.stats == je.stats and te.stats["padded_tokens"] > 0


def test_prefill_decode_agree_with_plain_forward(models):
    _, te = engines(models)
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, 128, (2, 16)).astype(np.int32))
    logits, cache, _ = te.prefill(tok)
    full, _, _ = te.model.apply(te.params, {"tokens": tok})
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), atol=1e-4)
    nxt, cache, _ = te.decode(cache, tok[:, -1:])
    assert nxt.shape == (2, 1) and cache["offset"] == 17


def test_generate_deterministic_and_shaped(models):
    _, te = engines(models)
    tok = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, (2, 12)).astype(np.int32))
    out1 = te.generate(tok, steps=5)
    assert out1.shape == (2, 5)
    assert torch.equal(out1, te.generate(tok, steps=5))


def test_oversized_request_raises_clear_error(models):
    _, te = engines(models)
    with pytest.raises(ValueError, match="bucket"):
        te.prefill(torch.zeros((5, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="bucket"):
        te.generate(torch.zeros((5, 8), dtype=torch.int32), steps=2)
    with pytest.raises(ValueError, match="bucket"):
        te.prefill(torch.zeros((2, 40), dtype=torch.int32))
    assert [_bucket(n, (2, 4)) for n in (1, 2, 3, 4)] == [2, 2, 4, 4]


def test_slo_classes_match_the_jax_classes():
    """The same pushes, pops, completions and windows on both copies."""
    rng = np.random.default_rng(4)
    qs, trs = (jslo.BoundedQueue(capacity=5), slo.BoundedQueue(capacity=5)), \
        (jslo.SLOTracker(slo_s=0.25), slo.SLOTracker(slo_s=0.25))
    now = 0.0
    for i in range(60):
        now += float(rng.uniform(0.0, 0.1))
        size = int(rng.integers(1, 4))
        for mod, q in zip((jslo, slo), qs):
            q.push(mod.Request(i, arrival_t=now, size=size))
        if i % 3 == 2:
            n = int(rng.integers(1, 4))
            t_done = now + float(rng.uniform(0.0, 0.5))
            for tr, q in zip(trs, qs):
                tr.complete(q.pop_batch(n), now=t_done)
    assert len(qs[0]) == len(qs[1]) and qs[0].drops == qs[1].drops > 0
    assert trs[0].completed == trs[1].completed
    for now_, h in ((now, 1.0), (now, 3.0), (now + 1.0, 0.5)):
        assert trs[0].window(now_, h) == trs[1].window(now_, h)


def test_slo_window_counts_only_on_time():
    tr = slo.SLOTracker(slo_s=0.25)
    tr.complete([slo.Request(0, arrival_t=0.0), slo.Request(1, arrival_t=0.9)],
                now=1.0)
    thr, eff, lat = tr.window(now=1.0)
    assert (thr, eff) == (2.0, 1.0) and abs(lat - 0.55) < 1e-12


def test_fleet_init_takes_an_slo_override():
    cfg = FCPOConfig()
    fleet = fleet_init(cfg, 3, 0, device="cpu", slo_s=0.4)
    # the JAX fleet_init maps default_env_params(speed, slo_s) over agents
    want = j_default_env_params(jnp.float32(1.0), 0.4).slo_s
    np.testing.assert_array_equal(fleet.env_params.slo_s.numpy(),
                                  np.full(3, np.asarray(want)))
    assert float(fleet_init(cfg, 2, 0, device="cpu").env_params.slo_s[0]) \
        == cfg.slo_s


def test_serve_launcher_runs_on_the_cpu(capsys):
    summ = serve.main(["--device", "cpu", "--reduced", "--replicas", "2",
                       "--episodes", "2"])
    for key in ("reward", "effective_throughput", "latency", "bs",
                "generate_s"):
        assert summ[key].shape == (2,) and np.isfinite(summ[key]).all()
    assert set(summ["bs"]) <= {1, 2, 4, 8}
    # the calibration's floors, as the float32 the env params store
    assert summ["t0"] >= np.float32(1e-4) and summ["t1"] >= np.float32(1e-5)
    out = capsys.readouterr().out
    assert "calibrated latency model" in out and out.rstrip().endswith("done")


def test_serve_launcher_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--episodes", "1"])
