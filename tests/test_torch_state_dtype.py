"""State dtype policies of the port (``repro_torch.core.dtypes``) against
``repro.core.dtypes`` and the JAX fleet, on the CPU.

The casts, the int8 quantization and ``fleet_cast`` equal the JAX
package's bit for bit, leaf dtypes included (the port keeps four index
leaves int64: their values are compared). One episode and one FL round per
policy match JAX's with its Gumbel noise replayed: actions, selection and
integer state exactly, float leaves within the bf16 band below. Within the
port, the two drivers agree bit for bit under every policy, the float32
policy is a fleet built without one, and lean trains like float32.

Bands: float32 leaves rtol 1e-4 / atol 1e-5 (the repo's float32 band);
bf16 leaves ``|got - want| <= 2**-6 * (|want| + max|want|)``: two bf16
ulps of the value plus two of the leaf's largest magnitude, for values
near zero that a float32 roundoff upstream moves across a bf16 step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import dtypes as jdtp
from repro.core import env as jenv
from repro.core import fleet as jfleet
from repro.core.backends import FLUID
from repro.core.backends import TwinBackend as JTwin
from repro.core.buffer import buffer_cast as j_buffer_cast
from repro.fl import transport as jtr
from repro.resilience.guards import DEFAULT_GUARDS
from repro.sim.state import SimParams as JSimParams
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import dtypes as tdtp
from repro_torch.core import env as tenv
from repro_torch.core import fleet as tfleet
from repro_torch.core.backends import TwinBackend
from repro_torch.core.buffer import DiversityBuffer
from repro_torch.core.buffer import buffer_cast as t_buffer_cast
from repro_torch.core.crl import EPISODE_METRICS
from repro_torch.core.graphs import copy_into
from repro_torch.fl import transport as ttr
from repro_torch.kernels.diversity import diversity_insert
from repro_torch.resilience import faults as tfaults
from repro_torch.sim.state import SimParams
from test_torch_support import (_flat, close, exact, head_sizes,
                                jax_episode_noise, jax_fleet_tree,
                                to_rollout)

A, P = 4, 2
CFG_J, CFG_T = JCfg(fl_every=1), TCfg(fl_every=1)
POLICIES = tuple(tdtp.POLICIES)
BACKENDS = {"fluid": (None, None),
            "twin": (JTwin(sp=JSimParams()), TwinBackend(sp=SimParams()))}
# the port's int64 index leaves, int32 in the JAX fleet
INT64 = ("actions", "cur_action")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def widen(x):
    """A numpy leaf as float64 (bf16 as ``|V2`` or ml_dtypes widened)."""
    x = np.asarray(x)
    if x.dtype.kind == "V":
        x = x.view(ml_dtypes.bfloat16)
    return x.astype(np.float64)


def same_dtype(got, want, name):
    """The port's numpy leaf has the JAX leaf's dtype (bf16 as ``|V2``)."""
    g, w = np.asarray(got).dtype, np.asarray(want).dtype
    if w == ml_dtypes.bfloat16:
        assert g == np.dtype("V2"), f"{name}: {g} is not bf16"
    elif name.endswith(INT64):
        assert g == np.int64 and w == np.int32, f"{name}: {g} / {w}"
    else:
        assert g == w, f"{name}: {g} != {w}"


def bits(x):
    """The raw bits of a numpy leaf (bf16 and int8 compared as stored)."""
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint16) if x.dtype.kind == "V" or \
        x.dtype == ml_dtypes.bfloat16 else x


def exact_tree(got: dict, want: dict):
    g, w = _flat(got), _flat(want)
    for name, wv in w.items():
        same_dtype(g[name], wv, name)
        if name.endswith(INT64):
            exact(g[name], wv, name)
        else:
            np.testing.assert_array_equal(bits(g[name]), bits(wv),
                                          err_msg=name)


def banded_tree(got: dict, want: dict):
    """Integers exact, float32 in its band, bf16 in the bf16 band."""
    g, w = _flat(got), _flat(want)
    for name, wv in w.items():
        same_dtype(g[name], wv, name)
        wv = np.asarray(wv)
        if wv.dtype == ml_dtypes.bfloat16:
            a, b = widen(g[name]), widen(wv)
            tol = 2.0 ** -6 * (np.abs(b) + np.abs(b).max())
            assert (np.abs(a - b) <= tol).all(), \
                f"{name}: {np.abs(a - b).max()} off"
        elif np.issubdtype(wv.dtype, np.floating):
            close(g[name], wv, name)
        else:
            exact(g[name], wv, name)


@pytest.fixture(scope="module")
def trained():
    """JAX fleets (fluid, twin) after one float32 episode and FL round, so
    that buffers, moments, env state and residuals are not trivial."""
    rates = jnp.asarray(np.random.default_rng(3).uniform(5, 150, (A, 10)),
                        jnp.float32)
    out = {}
    for name, (jb, _) in BACKENDS.items():
        jf = jfleet.fleet_init(CFG_J, A, jax.random.PRNGKey(0), n_pods=P,
                               env_backend=jb)
        jf, roll, _ = jfleet.fleet_episode(CFG_J, jf, rates, learn=True,
                                           backend=jb or FLUID, health=None)
        jf, _, _ = jfleet.fl_round(
            CFG_J, jf, roll, jnp.ones(A, bool),
            transport=jtr.TransportConfig(codec="int8"),
            guards=DEFAULT_GUARDS, faults=None, byzantine=None,
            fault_key=None, health=None)
        out[name] = jf
    return out


# ---------------------------------------------------------------------------
# the policy table, the casts and the quantization
# ---------------------------------------------------------------------------
def test_policy_table_is_the_reference_table():
    assert tuple(tdtp.POLICIES) == tuple(jdtp.POLICIES)
    for name, pol in jdtp.POLICIES.items():
        assert dataclasses.asdict(tdtp.POLICIES[name]) == \
            dataclasses.asdict(pol)
    assert tdtp.get_policy(None) == tdtp.POLICIES["float32"]
    msgs = []
    for mod in (jdtp, tdtp):
        with pytest.raises(ValueError) as err:
            mod.get_policy("fp8")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert (tdtp.STATE_SCALE, tdtp.PROB_SCALE) == \
        (jdtp.STATE_SCALE, jdtp.PROB_SCALE)


@pytest.mark.parametrize("scale", ["STATE_SCALE", "PROB_SCALE"])
def test_quant8_and_bf16_casts_match_jax_bit_for_bit(scale):
    """``quant8`` / ``dequant8`` against the reference as it runs in the
    episode (compiled), on values around every rounding tie; the bf16 cast
    rounds to nearest even as JAX's does; ``float32`` casts are the
    identity."""
    s = getattr(jdtp, scale)
    rng = np.random.default_rng(0)
    ties = (np.arange(-300, 300) + 0.5) * s
    x = np.concatenate([rng.uniform(-5, 5, 200_000), ties,
                        np.nextafter(ties, 0), np.nextafter(ties, 9)]
                       ).astype(np.float32)
    q_j = np.asarray(jax.jit(lambda v: jdtp.quant8(v, s))(x))
    q_t = tdtp.quant8(torch.from_numpy(x), s)
    assert q_t.dtype == torch.int8
    exact(q_t, q_j)
    exact(tdtp.dequant8(q_t, s), np.asarray(jdtp.dequant8(jnp.asarray(q_j),
                                                          s)))
    exact(tdtp.quant8(tdtp.dequant8(q_t, s), s), q_j)      # idempotent
    b_t = tdtp.cast_floats({"x": torch.from_numpy(x)}, "bfloat16")["x"]
    b_j = jdtp.cast_floats({"x": jnp.asarray(x)}, "bfloat16")["x"]
    np.testing.assert_array_equal(bits(tdtp.to_numpy(b_t)), bits(b_j))
    t = torch.from_numpy(x)
    assert tdtp.cast_floats({"x": t}, "float32")["x"] is t
    ints = tdtp.cast_floats({"i": torch.arange(3)}, "bfloat16")["i"]
    assert ints.dtype == torch.int64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_buffer_cast_matches_jax(trained, dtype):
    """A filled buffer to each storage dtype and back to float32."""
    jbuf = trained["fluid"].astate.buffer
    tbuf = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(trained["fluid"]),
                                   device="cpu").astate.buffer
    for d in (dtype, "float32"):
        jbuf = j_buffer_cast(jbuf, d)
        tbuf = t_buffer_cast(tbuf, d)
        exact_tree(tfleet._numpy_fields(tbuf),
                   jax.tree.map(np.asarray, jbuf._asdict()))
    with pytest.raises(ValueError, match="unknown buffer storage dtype"):
        t_buffer_cast(tbuf, "fp8")


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("policy", POLICIES)
def test_fleet_cast_matches_jax_bit_for_bit(trained, backend, policy):
    """``fleet_cast`` of a trained fleet to each policy, then back to
    float32: every leaf's dtype and bits are JAX's."""
    jf = trained[backend]
    tf = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(jf), device="cpu")
    for pol in (policy, "float32"):
        jf, tf = jfleet.fleet_cast(jf, pol), tfleet.fleet_cast(tf, pol)
        exact_tree(tfleet.fleet_to_numpy(tf), jax_fleet_tree(jf))
    # the numpy carry keeps the dtypes both ways
    lean = tfleet.fleet_cast(tf, policy)
    back = tfleet.fleet_from_numpy(CFG_T, tfleet.fleet_to_numpy(lean),
                                   device="cpu")
    identical_tree(tfleet.fleet_to_numpy(back), tfleet.fleet_to_numpy(lean))


def test_float32_cast_is_the_identity():
    f = tfleet.fleet_init(CFG_T, A, 0, n_pods=P, device="cpu")
    g = tfleet.fleet_cast(f, "float32")
    assert g.astate.policy is f.astate.policy and g.base is f.base
    for k, v in f.residuals.items():
        assert g.residuals[k] is v
    for name in ("states", "probs", "score", "s_outer"):
        assert getattr(g.astate.buffer, name) is \
            getattr(f.astate.buffer, name)


# sizes of the port's int64 index leaves beyond JAX's int32, per family
def int64_extra(a, p, cfg):
    return {"buffer": a * cfg.buffer_size * 3 * 4, "env": a * 3 * 4,
            "misc": a * 4 + 3 * a * 4}


@pytest.mark.parametrize("policy", POLICIES)
def test_state_bytes_match_jax(policy):
    """``fleet_state_bytes`` by family at A=8, P=2 (the CLI's default):
    JAX's 825,832 / 509,480 / 407,224 B in total, plus the port's int64
    index leaves."""
    a, p = 8, 2
    want = jfleet.fleet_state_bytes(jfleet.fleet_init(
        CFG_J, a, jax.random.PRNGKey(0), n_pods=p, state_policy=policy))
    got = tfleet.fleet_state_bytes(tfleet.fleet_init(
        CFG_T, a, 0, n_pods=p, device="cpu", state_policy=policy))
    extra = int64_extra(a, p, CFG_T)
    assert want["total"] == {"float32": 825832, "bf16": 509480,
                             "lean": 407224}[policy]
    for fam in ("model", "opt", "buffer", "env", "transport", "health",
                "misc"):
        assert got[fam] == want[fam] + extra.get(fam, 0), fam
    assert got["total"] == want["total"] + sum(extra.values())


def test_lean_is_half_the_bytes_per_agent_at_scale():
    """JAX's gate: lean >= 2x smaller per agent at A=256, P=8."""
    f32 = tfleet.fleet_state_bytes(tfleet.fleet_init(
        CFG_T, 256, 0, n_pods=8, device="cpu"))
    lean = tfleet.fleet_state_bytes(tfleet.fleet_init(
        CFG_T, 256, 0, n_pods=8, device="cpu", state_policy="lean"))
    assert f32["per_agent"] / lean["per_agent"] >= 2.0


# ---------------------------------------------------------------------------
# the bf16 env step: the reference's compiled arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("form", ["compiled", "written"])
def test_bf16_env_step_is_the_compiled_reference(form, monkeypatch):
    """Ten chained fluid steps of a bf16 env state and params (A=256, rates
    1-400) against JAX's jitted step, as ``fleet_episode`` runs it: the
    queues, drops and EMA latency exactly, the reward in the float32 band.
    What closed the gap: the literal 0.7 of the EMA is rounded to bf16
    (JAX's weak typing, ``dtypes.weak``) and its product with the bf16 EMA
    stays float32 (XLA's excess precision). ``written``: with the literal
    left float32 the EMA misses by a bf16 ulp at some agents (the gap the
    port had before), while the queues still agree."""
    if form == "written":
        monkeypatch.setattr(tenv, "weak", lambda x, like: x)
    a = 256
    rng = np.random.default_rng(0)
    speeds = rng.choice([0.5, 0.75, 1.0, 2.0], a).astype(np.float32)
    jep = jdtp.cast_floats(jax.vmap(lambda s: jenv.default_env_params(
        s, 0.25))(jnp.asarray(speeds)), jnp.bfloat16)
    jes = jdtp.cast_floats(jax.vmap(lambda _: jenv.env_init(CFG_J))(
        jnp.arange(a)), jnp.bfloat16)
    tep = tdtp.tree_f32(tenv.EnvParams(**{
        k: tdtp.from_numpy(v) for k, v in jax.tree.map(
            np.asarray, jep._asdict()).items()}))
    tes = tenv.EnvState(**{k: tdtp.from_numpy(v) for k, v in jax.tree.map(
        np.asarray, jes._asdict()).items()})
    tes.cur_action = tes.cur_action.long()
    step = jax.jit(jax.vmap(lambda ep, s, ac, r: jenv.env_step(
        CFG_J, ep, s, ac, r)))
    ema_off = 0
    for _ in range(10):
        act = rng.integers(0, [4, 7, 4], size=(a, 3)).astype(np.int32)
        rate = rng.uniform(1, 400, a).astype(np.float32)
        jes2, r_j, _ = step(jep, jes, jnp.asarray(act), jnp.asarray(rate))
        jes = jdtp.tree_cast_like(jes2, jes)
        tes2, r_t, _ = tenv.env_step(CFG_T, tep, tes,
                                     torch.from_numpy(act).long(),
                                     torch.from_numpy(rate))
        tes = tdtp.tree_cast_like(tes2, tes)
        for k in ("pre_q", "post_q", "drops"):
            np.testing.assert_array_equal(
                bits(tdtp.to_numpy(getattr(tes, k))),
                bits(getattr(jes, k)), err_msg=k)
        ema_off += int((bits(tdtp.to_numpy(tes.ema_lat))
                        != bits(jes.ema_lat)).sum())
        if form == "compiled":
            close(r_t, r_j, "reward")
        tes.ema_lat = tdtp.from_numpy(np.asarray(jes.ema_lat))  # resync
    assert tes.ema_lat.dtype == torch.bfloat16
    assert (ema_off == 0) == (form == "compiled"), ema_off


# ---------------------------------------------------------------------------
# one episode and one FL round per policy against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy", POLICIES)
def test_episode_and_round_match_jax(policy):
    """A fluid lean / bf16 / float32 fleet (A=8, P=2) through one episode
    and one int8 round with a deadline, JAX's action noise replayed:
    actions, selection, env integer state and every int leaf exact, floats
    in their bands. (The JAX twin cannot step a bf16 fleet: see
    ``test_reference_twin_refuses_a_bf16_fleet``.)"""
    a = 8
    jf = jfleet.fleet_init(CFG_J, a, jax.random.PRNGKey(0), n_pods=P,
                           state_policy=policy)
    tf = tfleet.fleet_from_numpy(CFG_T, jax_fleet_tree(jf), device="cpu")
    rates = np.random.default_rng(3).uniform(5, 150, (a, 10)).astype(
        np.float32)
    g, _ = jax_episode_noise(jf.astate.rng, CFG_J.n_steps, head_sizes(CFG_J))
    jf, roll_j, met_j = jfleet.fleet_episode(CFG_J, jf, jnp.asarray(rates),
                                             learn=True, backend=FLUID,
                                             health=None)
    tf, roll_t, met_t = tfleet.fleet_episode(
        CFG_T, tf, torch.tensor(rates), learn=True,
        gumbel=torch.tensor(np.asarray(g)))
    exact(roll_t.actions, roll_j.actions)
    for k in EPISODE_METRICS:
        close(met_t[k], met_j[k], k)
    banded_tree(tfleet.fleet_to_numpy(tf), jax_fleet_tree(jf))
    tr = dict(codec="int8", deadline_s=0.002)
    avail = np.array([1, 0, 1, 1, 1, 1, 0, 1], bool)
    jf, sel_j, fl_j = jfleet.fl_round(
        CFG_J, jf, roll_j, jnp.asarray(avail),
        transport=jtr.TransportConfig(**tr), guards=DEFAULT_GUARDS,
        faults=None, byzantine=None, fault_key=None, health=None)
    tf, sel_t, fl_t = tfleet.fl_round(
        CFG_T, tf, to_rollout(roll_j), torch.tensor(avail),
        transport=ttr.TransportConfig(**tr))
    exact(sel_t, sel_j)
    for k, v in fl_t.items():
        close(v, fl_j[k], k)
    banded_tree(tfleet.fleet_to_numpy(tf), jax_fleet_tree(jf))


def test_reference_twin_refuses_a_bf16_fleet():
    """A reference fault the port avoids (ROADMAP queue 3): the JAX twin's
    microtick scan carries the credits and latency sum at the stored bf16
    and computes them float32, which ``lax.scan`` refuses. The port reads
    them up to float32 around K3 and stores them back after the step."""
    jf = jfleet.fleet_init(CFG_J, 2, jax.random.PRNGKey(0),
                           env_backend=BACKENDS["twin"][0],
                           state_policy="bf16")
    rates = jnp.full((2, CFG_J.n_steps), 40.0)
    with pytest.raises(TypeError, match="carry"):
        jfleet.fleet_episode(CFG_J, jf, rates, learn=True,
                             backend=BACKENDS["twin"][0], health=None)
    tf = tfleet.fleet_init(CFG_T, 2, 0, device="cpu",
                           env_backend=BACKENDS["twin"][1],
                           state_policy="bf16")
    tf, _, met = tfleet.fleet_episode(CFG_T, tf, torch.full(
        (2, CFG_T.n_steps), 40.0), backend=BACKENDS["twin"][1])
    assert tf.astate.env_state.sim.credits.dtype == torch.bfloat16
    assert all(torch.isfinite(v).all() for v in met.values())


# ---------------------------------------------------------------------------
# within the port: both drivers, float32 == no policy, lean ~ float32
# ---------------------------------------------------------------------------
def traces_np(a, n_eps, seed=1):
    return np.random.default_rng(seed).uniform(
        5.0, 160.0, (a, n_eps * CFG_T.n_steps)).astype(np.float32)


CHAOS = dict(faults=tfaults.FaultConfig(
    crash_prob=0.2, byzantine_frac=0.3, byzantine_mode="noise",
    byzantine_scale=2.0, partition_prob=0.5, seed=3))


def run(drive, policy, backend, n_eps=6, **kw):
    tb = BACKENDS[backend][1]
    fleet = tfleet.fleet_init(CFG_T, A, 0, n_pods=P, device="cpu",
                              env_backend=tb, state_policy=policy)
    return drive(CFG_T, fleet, torch.tensor(traces_np(A, n_eps)),
                 straggler_prob=0.25, seed=7, env_backend=tb,
                 transport=ttr.TransportConfig(codec="int8",
                                               deadline_s=0.002,
                                               async_rounds=True), **kw)


def identical_tree(got: dict, want: dict):
    """Two port trees: the same dtypes and bits, leaf by leaf."""
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for name, wv in w.items():
        assert g[name].dtype == wv.dtype, name
        np.testing.assert_array_equal(bits(g[name]), bits(wv), err_msg=name)


def same_run(r1, r2):
    (f1, h1), (f2, h2) = r1, r2
    assert set(h1) == set(h2)
    for k, v in h1.items():
        np.testing.assert_array_equal(v, h2[k], err_msg=k)
    identical_tree(tfleet.fleet_to_numpy(f1), tfleet.fleet_to_numpy(f2))


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("policy", POLICIES)
def test_scan_is_the_reference_per_policy(backend, policy):
    """The same narrow carry through both drivers (async int8 rounds,
    crashes, byzantine noise, partitions): bit for bit, where JAX's own
    test holds only allclose. One K1 launch an episode either way on the
    card; here the plain version runs."""
    before = diversity_insert.launches
    same_run(run(tfleet.train_fleet_scan, policy, backend, **CHAOS),
             run(tfleet.train_fleet_reference, policy, backend, **CHAOS))
    assert diversity_insert.launches == before


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_float32_policy_is_no_policy(backend):
    same_run(run(tfleet.train_fleet_scan, None, backend),
             run(tfleet.train_fleet_scan, "float32", backend))


def test_lean_trains_like_float32():
    """JAX's gate: lean's last-quarter reward within 0.1 of float32's."""
    n_eps = 8
    _, h32 = run(tfleet.train_fleet_scan, None, "fluid", n_eps)
    _, hl = run(tfleet.train_fleet_scan, "lean", "fluid", n_eps)
    tail = max(n_eps // 4, 2)
    assert abs(hl["reward"][-tail:].mean() - h32["reward"][-tail:].mean()) \
        < 0.1


# ---------------------------------------------------------------------------
# the repair of copy_into
# ---------------------------------------------------------------------------
def test_copy_into_refuses_a_dtype_mismatch():
    """A silent cast in the static carry would store what the reference
    driver does not: ``copy_into`` names the leaf instead."""
    dst = {"a": torch.zeros(3), "opt": {"m": torch.zeros(2, dtype=
                                                         torch.bfloat16)}}
    src = {"a": torch.ones(3), "opt": {"m": torch.ones(2)}}
    with pytest.raises(TypeError, match=r"opt\.m is torch.float32"):
        copy_into(dst, src)
    buf = tfleet.fleet_init(CFG_T, 2, 0, device="cpu",
                            state_policy="lean").astate.buffer
    wide = t_buffer_cast(buf, "float32")
    with pytest.raises(TypeError, match="states"):
        copy_into(buf, wide)
    assert isinstance(buf, DiversityBuffer)
