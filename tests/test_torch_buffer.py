"""The port's Eq. 6 buffer engine (K1's plain version and
``core/buffer.py``) against the JAX package on the CPU.

The JAX side runs its jnp oracle (``repro.kernels.ref``) and its Pallas
``diversity_insert`` kernel in interpret mode, as its own tests do. Floats
within rtol 1e-4 / atol 1e-5; decision traces identical, except that a
first divergence is reported and accepted at a near-tie (score gap below
1e-5 relative). Seeds 1 and 3 of tests/test_buffer.py's randomized case
are run as a probe.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import buffer as jbuf
from repro.kernels import ref as jref
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import buffer as tbuf
from repro_torch.kernels import ref as tref
from repro_torch.kernels.diversity import diversity_insert
from test_torch_support import (NEAR_TIE, close, exact,
                                first_divergence, near_tie_gap)

KW = dict(alpha=0.5, beta=0.5, ridge=0.1)
NA = 15


def cands_np(rng, a, t, scale=2.0):
    s = (rng.normal(size=(a, t, 8)) * scale).astype(np.float32)
    logits = rng.normal(size=(a, t, NA))
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return s, p.astype(np.float32)


def empty_state(n, a):
    b = jbuf.buffer_init(JCfg(buffer_size=n))
    return [np.broadcast_to(np.asarray(x), (a,) + x.shape).copy()
            for x in (b.states, b.probs, b.score, b.filled, b.s_sum,
                      b.s_outer, b.p_sum, b.n_filled)]


j_insert = jax.jit(jax.vmap(lambda *xs: jref.diversity_insert_ref(*xs, **KW)))


def prefilled(rng, n, a, fill):
    state = empty_state(n, a)
    if fill:
        s, p = cands_np(rng, a, fill)
        state = [np.asarray(x) for x in j_insert(*state, s, p)[:8]]
    return state


def t_args(state, s, p):
    return [torch.tensor(x) for x in state] + [torch.tensor(s),
                                                torch.tensor(p)]


def assert_insert_matches(out_t, out_j, state, s, p, label):
    """Identical traces (near-tie rule), floats within the band on the
    agents that did not diverge."""
    slot_t, do_t, d_t = (x.numpy() for x in out_t[8:])
    slot_j, do_j, d_j = (np.asarray(x) for x in out_j[8:])
    div = first_divergence(slot_t, do_t, slot_j, do_j)
    for a, t in div.items():
        pre = j_insert(*state, s[:, :t], p[:, :t])[2] if t else state[2]
        gap = near_tie_gap(np.asarray(pre)[a], d_t[a, t], d_j[a, t],
                           slot_t[a, t], slot_j[a, t])
        assert gap <= NEAR_TIE * max(1.0, abs(float(d_j[a, t]))), \
            f"{label}: agent {a} diverges at t={t} with score gap {gap}"
        print(f"{label}: agent {a} diverges at t={t} at a near-tie "
              f"(gap {gap:.3g}) — accepted")
    keep = np.array([a not in div for a in range(slot_t.shape[0])])
    names = ("states", "probs", "score", "filled", "s_sum", "s_outer",
             "p_sum", "n_filled", "slot", "do", "d")
    for name, x, y in zip(names, out_t, out_j):
        x, y = x.numpy()[keep], np.asarray(y)[keep]
        if np.issubdtype(y.dtype, np.floating):
            close(x, y, f"{label}: {name}")
        else:
            exact(x, y, f"{label}: {name}")
    return div


@pytest.mark.parametrize("n,fill", [(8, 0), (8, 5), (16, 40), (64, 100)])
def test_diversity_insert_plain_matches_jax_oracle(n, fill):
    """K1's plain version == vmap(repro ``diversity_insert_ref``) from
    empty, partly filled and full buffers, 20 candidates per agent."""
    rng = np.random.default_rng(n + fill)
    a = 4
    state = prefilled(rng, n, a, fill)
    s, p = cands_np(rng, a, 20)
    out_t = diversity_insert(*t_args(state, s, p), **KW)
    out_j = j_insert(*state, s, p)
    assert_insert_matches(out_t, out_j, state, s, p, f"n={n} fill={fill}")


@pytest.mark.pallas
def test_diversity_insert_plain_matches_pallas_kernel():
    """... and == the Pallas kernel (interpret mode on the CPU)."""
    from repro.kernels import ops as kops
    rng = np.random.default_rng(11)
    a, n = 3, 8
    state = prefilled(rng, n, a, 6)
    s, p = cands_np(rng, a, 12)
    out_j = kops.diversity_insert(*[jnp.asarray(x) for x in state],
                                  jnp.asarray(s), jnp.asarray(p), alpha=0.5,
                                  beta=0.5)
    out_t = diversity_insert(*t_args(state, s, p), **KW)
    assert_insert_matches(out_t, out_j, state, s, p, "pallas")


def pallas_case(name):
    """(state, cand_states, cand_probs) of the cases K1's redesign touches:
    slot scores tied at the minimum (the argmin takes the lower index), a
    NaN slot score (NaN is the minimum; nothing goes in), N=128 slots (four
    per lane of a warp), one candidate (T=1), and a buffer that goes from
    empty to full within the episode."""
    n, fill, t = dict(tied=(8, 12, 10), nan=(8, 12, 6), n128=(128, 140, 12),
                      t1=(16, 20, 1), empty_to_full=(8, 0, 20))[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    a = 3
    state = [np.array(x) for x in prefilled(rng, n, a, fill)]
    if name == "tied":
        score = state[2]
        score[:, [2, 5, 6]] = score.min(-1, keepdims=True)
    if name == "nan":
        state[2][:, 3] = np.nan
    s, p = cands_np(rng, a, t)
    return state, s, p


@pytest.mark.pallas
@pytest.mark.parametrize("name", ["tied", "nan", "n128", "t1",
                                  "empty_to_full"])
def test_diversity_insert_plain_matches_pallas_cases(name):
    """K1's plain version == the Pallas kernel (interpret mode) on the
    cases of ``pallas_case``; the decisions that those cases force are
    checked too."""
    from repro.kernels import ops as kops
    state, s, p = pallas_case(name)
    out_j = kops.diversity_insert(*[jnp.asarray(x) for x in state],
                                  jnp.asarray(s), jnp.asarray(p), **KW)
    out_t = diversity_insert(*t_args(state, s, p), **KW)
    div = assert_insert_matches(out_t, out_j, state, s, p, f"pallas {name}")
    slot, do = out_t[8].numpy(), out_t[9].numpy()
    if name == "tied":      # the lowest of the tied slots goes first
        assert all(slot[a, 0] == 2 for a in range(3) if a not in div)
    if name == "nan":       # the NaN slot is the minimum: nothing goes in
        assert (slot == 3).all() and not do.any()
        assert np.isnan(out_t[2].numpy()[:, 3]).all()
    if name == "empty_to_full":
        assert (slot[:, :8] == np.arange(8)).all() and do[:, :8].all()
        assert out_t[3].numpy().all() and (out_t[7].numpy() == 8).all()


def test_k1_stamps_anchor_in_todays_source():
    """K1's phase marks are empty in ``csrc/diversity_insert.cu`` as built
    (no timing code), every phase that ``chip_smoke.py`` reads is marked in
    today's source, and its timing build defines the marks as clock64
    stamps before it includes that source."""
    import importlib.util
    import re
    from pathlib import Path
    from repro_torch.kernels import build
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    source = build.CSRC / "diversity_insert.cu"
    src = source.read_text()
    assert "clock64" not in re.sub(r"//.*", "", src)
    guard = src[src.index("#ifndef K1_PHASE_MARKS"):]
    guard = guard[:guard.index("#endif")]
    for mark in ("K1_MARK_START()", "K1_MARK(phase)", "K1_MARK_END()"):
        assert f"#define {mark}\n" in guard
    marks = re.findall(r"^ *K1_MARK\((\w+)\);$", src, re.M)
    assert set(marks) == {mark for mark, _ in smoke.K1_PHASES}
    assert src.count("K1_MARK_START();") == src.count("K1_MARK_END();") == 1
    unit = smoke.stamped_source("K1", smoke.K1_PHASES, source, smoke.K1_WARPS)
    assert (unit.index("#define K1_PHASE_MARKS")
            < unit.index("#define K1_MARK(phase) k1_stamp(K1_PH_##phase)")
            < unit.index(f'#include "{source}"'))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_randomized_sequence_probe(seed):
    """tests/test_buffer.py's randomized sequence (buffer_size=8, 48
    candidates at scale 3) through the port and the JAX streaming engine.
    Seeds 1 and 3 are where the reference's streaming and recompute
    oracles disagree on jax 0.9.0; here any divergence must be a
    near-tie, and is reported."""
    cfg = JCfg(buffer_size=8)
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    s = np.asarray(jax.random.normal(ks[0], (1, 48, 8)) * 3.0)
    p = np.asarray(jax.nn.softmax(jax.random.normal(ks[5], (1, 48, NA)), -1))
    state = empty_state(cfg.buffer_size, 1)
    out_t = diversity_insert(*t_args(state, s, p), **KW)
    out_j = j_insert(*state, s, p)
    assert_insert_matches(out_t, out_j, state, s, p, f"probe seed {seed}")


def test_score_helpers_match_jax():
    """chol_small, tri_solve_small and the Eq. 6 score from moments."""
    rng = np.random.default_rng(4)
    a = 6
    x = rng.normal(size=(a, 20, 8)).astype(np.float32)
    s_sum = x.sum(1)
    s_outer = np.einsum("and,ane->ade", x, x)
    n_filled = np.array([0, 1, 5, 20, 20, 3], np.int32)
    probs = rng.dirichlet(np.ones(NA), size=a).astype(np.float32)
    p_sum = (rng.dirichlet(np.ones(NA), size=a) * 4).astype(np.float32)
    state = rng.normal(size=(a, 8)).astype(np.float32)
    want = jax.vmap(lambda *xs: jref.diversity_score_from_moments(
        *xs, alpha=0.5, beta=0.5))(state, probs, s_sum, s_outer, p_sum,
                                   n_filled)
    got = tref.diversity_score_from_moments(
        *(torch.tensor(v) for v in (state, probs, s_sum, s_outer, p_sum,
                                    n_filled)), alpha=0.5, beta=0.5)
    close(got, want)
    cov = s_outer / 20 + 0.1 * np.eye(8, dtype=np.float32)
    l_j = jax.vmap(jref.chol_small)(cov)
    l_t = tref.chol_small(torch.tensor(cov))
    close(l_t, l_j)
    close(tref.tri_solve_small(l_t, torch.tensor(state)),
          jax.vmap(jref.tri_solve_small)(l_j, state))


def test_insert_step_chain_matches_jax():
    """The single-insert step (explicit ``filled``), chained 12 times."""
    rng = np.random.default_rng(5)
    a, n = 4, 6
    st_j = [jnp.asarray(x) for x in empty_state(n, a)]
    st_t = [torch.tensor(np.asarray(x)) for x in st_j]
    s, p = cands_np(rng, a, 12)
    step_j = jax.jit(jax.vmap(lambda *xs: jref.diversity_insert_step(*xs,
                                                                     **KW)))
    for t in range(12):
        st_j, tr_j = step_j(*st_j, s[:, t], p[:, t])
        st_t, tr_t = tref.diversity_insert_step(
            *st_t, torch.tensor(s[:, t]), torch.tensor(p[:, t]), **KW)
        exact(tr_t[0], tr_j[0], f"slot t={t}")
        exact(tr_t[1], tr_j[1], f"do t={t}")
        close(tr_t[2], tr_j[2], f"d t={t}")
        for x, y in zip(st_t, st_j):
            if np.issubdtype(np.asarray(y).dtype, np.floating):
                close(x, y, f"state t={t}")
            else:
                exact(x, y, f"state t={t}")


def j_buffers(n, a):
    cfg = JCfg(buffer_size=n)
    return cfg, jax.vmap(lambda _: jbuf.buffer_init(cfg))(jnp.arange(a))


def buffers_close(bt, bj, label=""):
    for f in bj._fields:
        y = np.asarray(getattr(bj, f))
        x = getattr(bt, f)
        if np.issubdtype(y.dtype, np.floating):
            close(x, y, f"{label}{f}")
        else:
            exact(x, y, f"{label}{f}")


def test_buffer_insert_batch_matches_jax_last_writer_payload():
    """Two episodes into a 4-slot buffer (slots rewritten within one
    episode): the last writer's payload lands, moments and counts match,
    then resync / diversity mean / clear."""
    rng = np.random.default_rng(6)
    a, n, t = 3, 4, 10
    cfg_j, bj = j_buffers(n, a)
    cfg_t = TCfg(buffer_size=n)
    bt = tbuf.buffer_init(cfg_t, a, "cpu")
    ins_j = jax.jit(jax.vmap(lambda b, *xs: jbuf.buffer_insert_batch(
        cfg_j, b, *xs)))
    for ep in range(2):
        s, p = cands_np(rng, a, t, scale=3.0)
        act = rng.integers(0, 4, (a, t, 3)).astype(np.int32)
        lp, rw, vl = (rng.normal(size=(a, t)).astype(np.float32)
                      for _ in range(3))
        bj = ins_j(bj, s, act, lp, rw, vl, p)
        bt = tbuf.buffer_insert_batch(
            cfg_t, bt, torch.tensor(s), torch.tensor(act).long(),
            torch.tensor(lp), torch.tensor(rw), torch.tensor(vl),
            torch.tensor(p))
        buffers_close(bt, bj, f"episode {ep}: ")
    buffers_close(tbuf.buffer_resync(bt), jax.vmap(jbuf.buffer_resync)(bj),
                  "resync: ")
    close(tbuf.buffer_diversity_mean(bt), jbuf.buffer_diversity_mean(bj))
    buffers_close(tbuf.buffer_clear(bt), jax.vmap(jbuf.buffer_clear)(bj),
                  "clear: ")
