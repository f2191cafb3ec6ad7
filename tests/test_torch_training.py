"""LM training of the port (``training/optimizer.py``, ``train_step.py``,
``compression.py``, ``data/pipeline.py``, ``launch/train.py`` and the
train-state checkpoints) against the JAX package's, on the CPU.

Reduced configs in float32, the JAX model's initial parameters carried
across as numpy, the JAX pipeline's batches (numpy draws from a seed).

Tolerances. Losses, gradient norms, learning rates and the AdamW moments
agree within the repo's band, rtol 1e-4 / atol 1e-5. Parameters after
three AdamW steps are held at rtol 1e-4 / atol 1e-4 (``PARAM_TOL``): Adam
divides each gradient coordinate by its own running RMS, so a coordinate
whose gradient is small takes an O(lr) step that float32 roundoff in that
gradient moves by a few percent; at lr 3e-4 that leaves up to 3e-5 on a
parameter (measured: 2.1e-5 zamba2, 3.1e-5 xlstm). A coordinate whose
gradient is float32 roundoff away from zero can take that step the other
way: ``ADAM_FLIPS`` such coordinates a leaf may lie outside the band, each
by no more than twice the sum of the steps' learning rates (the most two
opposite AdamW paths can part; measured once, zamba2's Mamba in_proj, 2.1e-4).
Under ``--grad-compression`` the int8 tie rule of ``test_torch_support``
holds: a coordinate at a rounding tie may round the other way, at most two
a leaf a step, each off by one quantization step; such a coordinate
carries into the moments (``INT8_FLIPS`` a leaf, within 1 % of the leaf's
largest value) and the parameters (the Adam bound). Token batches, step
counters and checkpoint round trips are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.data import pipeline as jpipe
from repro.launch import train as j_train_cli
from repro.models.registry import get_model as j_get_model
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs.base import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import train as train_cli
from repro_torch.models.registry import get_model, params_to_numpy
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import compression as tcomp
from repro_torch.training import optimizer as topt
from repro_torch.training import train_step as tts

TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
ADAM_FLIPS = 2
INT8_FLIPS = 6          # two a leaf in each of three steps


def adam_bound(lrs):
    """The most a parameter can move between two AdamW runs over steps
    with learning rates ``lrs`` (|m^|/sqrt(v^) <= 1 per step, either way,
    plus a 1 % margin for the decay term)."""
    return 2.02 * float(sum(lrs))


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


def leaves(tree):
    """A port tree's tensors in JAX's leaf order, as numpy."""
    return [x.detach().numpy() for x in topt.flatten(tree)[0]]


def leaves_tree(tree):
    """A port tree as numpy, in its own nesting (the JAX package's)."""
    return params_to_numpy(tree)


def close_leaves(got, want, tol, what, flips=0, flip_bound=None):
    """Leaves within ``tol``; with ``flips``, up to that many coordinates a
    leaf may lie outside it, each by at most ``flip_bound`` (a float or a
    function of the leaf)."""
    want = [np.asarray(x) for x in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        if not flips:
            np.testing.assert_allclose(g, w, **tol,
                                       err_msg=f"{what} leaf {i}")
            continue
        bad = ~np.isclose(g, w, **tol)
        bound = flip_bound(w) if callable(flip_bound) else flip_bound
        assert bad.sum() <= flips and (np.abs(g - w)[bad] <= bound).all(), \
            f"{what} leaf {i}: {bad.sum()} coordinates off, max " \
            f"{np.abs(g - w)[bad].max() if bad.any() else 0}"


def random_tree(seed):
    """A nested dict / list tree of float32 arrays, as JAX's and the
    port's (the layout of a model's parameters)."""
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(5, 7)), "blocks": [
        {"a": rng.normal(size=(3,)), "b": rng.normal(size=(2, 4))}
        for _ in range(2)], "z": rng.normal(size=(4,)) * 1e-3}
    tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
    return jax.tree.map(j, tree), jax.tree.map(t, tree)


# ---------------------------------------------------------------------------
# optimizer and loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("piece", ["schedule", "norm_and_clip", "update"])
def test_optimizer_pieces_match_jax(piece):
    cfg = dict(warmup_steps=10, total_steps=100)
    jc, tc = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    if piece == "schedule":
        for s in (0, 1, 5, 10, 11, 55, 100, 130):
            got = topt.lr_schedule(tc, torch.tensor(s, dtype=torch.int32))
            want = jopt.lr_schedule(jc, jnp.asarray(s, jnp.int32))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                       atol=0)
        return
    jg, tg = random_tree(0)
    if piece == "norm_and_clip":
        for max_norm in (1.0, 100.0):
            wc, wn = jopt.clip_by_global_norm(jg, max_norm)
            gc, gn = topt.clip_by_global_norm(tg, max_norm)
            np.testing.assert_allclose(float(gn), float(wn), **TOL)
            close_leaves(leaves(gc), wc, TOL, "clipped")
        return
    jp, tp = random_tree(1)
    jstate, tstate = jopt.adamw_init(jp), topt.adamw_init(tp)
    for step in range(4):
        jg, tg = random_tree(10 + step)
        jp, jstate, jm = jopt.adamw_update(jc, jp, jg, jstate)
        tp, tstate, tm = topt.adamw_update(tc, tp, tg, tstate)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    close_leaves(leaves(tp), jp, TOL, "params")
    for k in ("m", "v"):
        close_leaves(leaves(tstate[k]), jstate[k], TOL, k)
    assert int(tstate["step"]) == int(jstate["step"]) == 4
    assert tstate["step"].dtype == torch.int32


@pytest.mark.parametrize("impl", ["gather", "sharded"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(impl, masked):
    """The value and its gradient with respect to the logits."""
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 9, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = rng.random((2, 9)) < 0.5 if masked else None
    jf = lambda lg: jts.cross_entropy(lg, j(labels), None if mask is None
                                      else j(mask), impl=impl)
    want, wgrad = jax.value_and_grad(jf)(j(logits))
    lt = t(logits).requires_grad_(True)
    got = tts.cross_entropy(lt, t(labels), None if mask is None
                            else t(mask), impl=impl)
    (ggrad,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(ggrad.numpy(), np.asarray(wgrad), **TOL)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------
# arch -> (microbatches, remat): each arch one variant; qwen2-0.5b's
# (2, remat) runs through both CLIs (test_train_cli_matches_jax_main)
STEP_CASES = {"zamba2-1.2b": (1, True), "xlstm-125m": (2, False),
              "granite-moe-3b-a800m": (1, False)}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_three_train_steps_match_jax(name):
    """Three steps of ``make_train_step`` (AdamW warmup 2 of 6) from the
    port's seeded init (carried to JAX as numpy) on the JAX pipeline's
    batches: loss, ce, moe_aux (granite's MoE in the loss at
    weight 0.01; 0 under microbatching, the reference's quirk), grad norm,
    lr and update_rejected per step; then params, moments and the step
    counter."""
    mb, remat = STEP_CASES[name]
    jc, tc = j_get_config(name).reduced(), get_config(name).reduced()
    jm, tm = j_get_model(jc), get_model(tc)
    tstate = tts.init_train_state(tm, torch.Generator().manual_seed(0))
    jp = jax.tree.map(j, leaves_tree(tstate["params"]))
    jstate = {"params": jp, "opt": jopt.adamw_init(jp)}
    ocfg = dict(warmup_steps=2, total_steps=6)
    jstep = jax.jit(jts.make_train_step(jm, jopt.AdamWConfig(**ocfg),
                                        microbatches=mb, remat=remat))
    tstep = tts.make_train_step(tm, topt.AdamWConfig(**ocfg),
                                microbatches=mb, remat=remat)
    pipe = jpipe.TokenPipeline(jc, 2, 32, seed=0)
    lrs = []
    for _ in range(3):
        batch = next(pipe)
        jstate, wm = jstep(jstate, batch)
        tstate, gm = tstep(tstate, jax.tree.map(t, batch))
        lrs.append(float(wm["lr"]))
        assert set(gm) == set(wm)
        for k in wm:
            np.testing.assert_allclose(float(gm[k]), float(wm[k]), **TOL,
                                       err_msg=k)
    assert (float(gm["moe_aux"]) > 0) == (name.startswith("granite")
                                         and mb == 1)
    close_leaves(leaves(tstate["params"]), jstate["params"], PARAM_TOL,
                 "params", ADAM_FLIPS, adam_bound(lrs))
    for k in ("m", "v"):
        close_leaves(leaves(tstate["opt"][k]), jstate["opt"][k], TOL, k)
    assert int(tstate["opt"]["step"]) == int(jstate["opt"]["step"]) == 3


def test_train_cli_matches_jax_main(capsys):
    """``launch/train.main`` against JAX's ``main``: reduced qwen2-0.5b,
    three steps of two microbatches with remat, from JAX's initial params
    (``params=``): the printed losses, grad norms and lrs (printed to 3-4
    decimals), then the final params, moments and step counter."""
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "32", "--microbatches", "2", "--log-every", "1"]
    want = j_train_cli.main(argv)
    want_log = capsys.readouterr().out
    init = jax.jit(j_get_model(j_get_config("qwen2-0.5b").reduced()).init)(
        jax.random.PRNGKey(0))
    got = train_cli.main(argv + ["--device", "cpu"],
                         params=jax.tree.map(np.asarray, init))
    got_log = capsys.readouterr().out
    nums = lambda log: np.array([[float(line.split()[i]) for i in (3, 5, 7)]
                                 for line in log.splitlines()
                                 if line.startswith("step")])
    assert nums(got_log).shape == (3, 3)
    np.testing.assert_allclose(nums(got_log), nums(want_log), rtol=2e-4,
                               atol=1e-3)    # the printed digits
    lrs = nums(want_log)[:, 2]
    close_leaves(leaves(got["params"]), want["params"], PARAM_TOL, "params",
                 ADAM_FLIPS, adam_bound(lrs))
    for k in ("m", "v"):
        close_leaves(leaves(got["opt"][k]), want["opt"][k], TOL, k)
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 3


def test_rejected_update_keeps_the_state():
    """A non-finite loss rejects the step: params and moments unchanged,
    the step counter too, ``update_rejected`` 1."""
    tc = get_config("qwen2-0.5b").reduced().replace(n_layers=1)
    tm = get_model(tc)
    state = tts.init_train_state(tm, torch.Generator().manual_seed(0))
    step = tts.make_train_step(tm, remat=False)
    tok = torch.zeros((2, 8), dtype=torch.int32)
    state["params"]["final_norm"]["g"][0] = float("nan")
    new, m = step(state, {"tokens": tok, "labels": tok})
    assert float(m["update_rejected"]) == 1.0
    for a, b in zip(leaves(new), leaves(state)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# data, compression, the CLI, checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["qwen2-0.5b", "hubert-xlarge",
                                  "pixtral-12b"])
def test_token_pipeline_batches_are_exact(name):
    """Tokens and labels, hubert's frames and span masks, pixtral's
    patches: three batches equal, dtypes the reference's; and the serving
    request stream."""
    cfg = get_config(name).reduced()
    jp = jpipe.TokenPipeline(j_get_config(name).reduced(), 3, 40, seed=5)
    tp = tpipe.TokenPipeline(cfg, 3, 40, seed=5, device="cpu")
    for _ in range(3):
        want, got = next(jp), next(tp)
        assert set(got) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    rates = np.array([0.5, 3.0, 1.2, 0.0, 4.0])
    for w, g in zip(jpipe.request_stream(cfg, rates, seed=2),
                    tpipe.request_stream(cfg, rates, seed=2)):
        assert [r for r, _ in g] == [r for r, _ in w]
        for (_, a), (_, b) in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _int8_residuals_close(got, want, what, flips=2):
    """The tie rule of ``test_torch_support.close_state`` on per-tensor
    int8 residuals: at most two coordinates a leaf a step (``flips`` in
    all) off the band, each by no more than one quantization step (>= 2
    max|residual|: error feedback keeps a residual within half a step)."""
    close_leaves(got, want, TOL, what, flips,
                 lambda w: 1.01 * 2 * np.abs(w).max())


def test_compress_psum_matches_jax():
    """``compress_psum`` in a world of one against JAX's inside a
    one-device ``shard_map``, the residuals carried over four steps."""
    from jax.sharding import PartitionSpec as P
    from repro.training.compression import compress_psum
    mesh = jax.make_mesh((1,), ("dp",))
    jfn = jax.jit(jax.shard_map(lambda g, r: compress_psum(g, r, "dp"),
                            mesh=mesh, in_specs=(P(), P()),
                            out_specs=(P(), P()), check_vma=False))
    jg, tg = random_tree(20)
    jr, tr = jax.tree.map(jnp.zeros_like, jg), tcomp.ef_init(tg)
    for step in range(4):
        jg, tg = random_tree(21 + step)
        jm, jr = jfn(jg, jr)
        tm, tr = tcomp.compress_psum(tg, tr)
        close_leaves(leaves(tm), jm, TOL, f"mean {step}")
        _int8_residuals_close(leaves(tr), jr, f"residual {step}")
    q, scale = tcomp.quantize_int8(tg["w"])
    assert q.dtype == torch.int8 and scale.shape == ()


def test_train_cli_with_grad_compression_matches_jax(tmp_path):
    """``launch/train.main --grad-compression`` in a world of one against
    the JAX CLI's compressed step (``_wrap_with_compression``'s ``local``:
    gradients, ``compress_psum``, AdamW, ``pmean`` of the loss) on one CPU
    device: per-step loss, ce, grad norm and lr, the final params and
    moments, the residuals (the int8 tie rule). The JAX CLI itself cannot
    run this path (ROADMAP queue 3: jax 0.9.0's
    ``jax.experimental.shard_map`` refuses its ``check_vma``, and its
    ``in_specs`` name an ``ef`` entry the state it passes lacks), so the
    step is rebuilt here from its pieces under ``jax.shard_map``. Then
    the checkpoint that each package writes restores in the other."""
    from jax.sharding import PartitionSpec as P
    from repro.training.compression import compress_psum
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "3", "--batch",
            "4", "--seq", "32", "--grad-compression"]
    hist = []
    jc = j_get_config("qwen2-0.5b").reduced()
    jm = j_get_model(jc)
    ocfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=3)
    loss_fn = jts.make_loss_fn(jm, remat=True)

    def local(state, batch):
        (loss, extras), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state["params"], batch)
        grads, res = compress_psum(grads, state["ef"], "dp")
        params, opt, om = jopt.adamw_update(ocfg, state["params"], grads,
                                            state["opt"])
        return ({"params": params, "opt": opt, "ef": res},
                {"loss": jax.lax.pmean(loss, "dp"), **extras, **om})
    jstep = jax.jit(jax.shard_map(local, mesh=jax.make_mesh((1,), ("dp",)),
                                  in_specs=(P(), P("dp")),
                                  out_specs=(P(), P()), check_vma=False))
    # the port's CLI from its seeded init, the JAX step from the same
    got = train_cli.main(argv + ["--device", "cpu", "--ckpt-dir",
                                 str(tmp_path / "port")], history=hist)
    init = tts.init_train_state(get_model(get_config("qwen2-0.5b").reduced()),
                                torch.Generator().manual_seed(0))["params"]
    jp = jax.tree.map(j, leaves_tree(init))
    want = {"params": jp, "opt": jopt.adamw_init(jp),
            "ef": jax.tree.map(jnp.zeros_like, jp)}
    pipe = jpipe.TokenPipeline(jc, 4, 32, seed=0)
    for gm in hist:
        want, wm = jstep(want, next(pipe))
        assert set(gm) == set(wm)
        for k in wm:
            np.testing.assert_allclose(float(gm[k]), float(wm[k]), **TOL,
                                       err_msg=k)
    lrs = [float(m["lr"]) for m in hist]
    close_leaves(leaves(got["params"]), want["params"], PARAM_TOL, "params",
                 INT8_FLIPS, adam_bound(lrs))
    for k in ("m", "v"):
        close_leaves(leaves(got["opt"][k]), want["opt"][k], TOL, k,
                     INT8_FLIPS, lambda w: 0.01 * np.abs(w).max())
    _int8_residuals_close(leaves(got["ef"]), want["ef"], "ef", INT8_FLIPS)
    # the JAX state saved by JAX into the port, the port's into JAX: exact
    jckpt.save(str(tmp_path / "jax"), 3, want, extra={"by": "jax"})
    back, manifest = tckpt.restore_tree(str(tmp_path / "jax"), 3, got)
    assert manifest["extra"] == {"by": "jax"}
    close_leaves(leaves(back), want, dict(rtol=0, atol=0), "jax -> port")
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        want)
    jback, manifest = jckpt.restore(str(tmp_path / "port"), 3, like)
    assert manifest["extra"] == {"arch": "qwen2-0.5b", "reduced": True}
    close_leaves(leaves(got), jback, dict(rtol=0, atol=0), "port -> jax")
    assert jback["opt"]["step"].dtype == jnp.int32


@pytest.mark.parametrize("compress", [False, True])
def test_resume_equals_the_straight_run(tmp_path, compress, capsys):
    """A 6-step run checkpointed every 3 steps; its step-3 checkpoint
    resumed with ``--resume`` ends at the straight run's state bit for bit
    (the token stream fast-forwarded past the first 3 batches; under
    ``--grad-compression`` the residuals restored)."""
    argv = ["--device", "cpu", "--arch", "xlstm-125m", "--reduced",
            "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-every",
            "3"] + (["--grad-compression"] if compress else [])
    straight = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    (tmp_path / "b").mkdir()
    for suffix in (".npz", ".json"):
        name = f"step_00000003{suffix}"
        (tmp_path / "b" / name).write_bytes(
            (tmp_path / "a" / name).read_bytes())
    resumed = train_cli.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                     "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert ("ef" in resumed) == compress
    for a, b in zip(leaves(resumed), leaves(straight)):
        np.testing.assert_array_equal(a, b)
