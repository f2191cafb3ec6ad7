"""The policy leaderboard of the PyTorch port (``repro_torch.eval.
leaderboard``) against the JAX package's, on the CPU.

The grid, the cell seeds and the gate functions (``attach_deltas``,
``check_regressions``, ``sanitize_envelope``) give JAX's results on the
same rows. The port's rows are bit-identical across runs and across
``n_jobs`` orders (its traces and noise come from ``torch.Generator``s
seeded by ``cell_seed``). One cell scored from JAX's draws (the cell's
traces, the fleet's action noise and the evaluation's noise, passed in
through ``draws``) lies within rtol 1e-4 / atol 1e-5 of JAX's row.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import fleet as jfleet
from repro.eval import leaderboard as jlb
from repro.sim import make_scenario as j_make_scenario
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import fleet as tfleet
from repro_torch.eval import leaderboard as tlb
from repro_torch.training import checkpoint as tckpt
from test_torch_support import (close, head_sizes, jax_episode_noise,
                                jax_fleet_tree, jax_sim_noise)

CELLS = [tlb.Cell("steady", "fluid", "int8"),
         tlb.Cell("burst", "twin", "float32"),
         tlb.Cell("drift", "fluid", "topk")]
SMALL = dict(episodes=2, eval_intervals=4, replicates=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleet():
    return tfleet.fleet_init(TCfg(), 2, 0, device="cpu")


def test_grid_and_cell_seeds_match_jax():
    t_cells, j_cells = tlb.grid_cells(), jlb.grid_cells()
    assert [(c.scenario, c.backend, c.codec, c.name) for c in t_cells] == \
        [(c.scenario, c.backend, c.codec, c.name) for c in j_cells]
    assert len(t_cells) == 9 * 2 * 3
    for tc, jc in zip(t_cells[::7], j_cells[::7]):
        for rep, tag in ((0, ""), (2, "eval"), (1, "key")):
            assert tlb.cell_seed(5, tc, rep, tag) == \
                jlb.cell_seed(5, jc, rep, tag)
    assert (tlb.GATE_METRICS, tlb.DELTA_KEYS, tlb.COMPAT_KEYS,
            tlb.DEFAULT_TOL, tlb.REPLICATES) == \
        (jlb.GATE_METRICS, jlb.DELTA_KEYS, jlb.COMPAT_KEYS,
         jlb.DEFAULT_TOL, jlb.REPLICATES)


def test_rows_bit_identical_across_runs_and_n_jobs(fleet):
    """Two runs and a two-stripe run over three cells (fluid and twin,
    every codec): the same rows, exactly; the input fleet untouched."""
    before = tckpt.fleet_flat(fleet)
    cfg = TCfg()
    rows = [tlb.run_leaderboard(cfg, fleet, CELLS, n_jobs=n, **SMALL)
            for n in (1, 1, 2)]
    assert rows[0] == rows[1] == rows[2]
    assert [r["name"] for r in rows[0]] == [c.name for c in CELLS]
    for r in rows[0]:
        for k in ("reward_mean", "eval_eff_mean", "eval_p99_mean",
                  "eval_slo_mean", "fl_payload_bytes"):
            assert np.isfinite(r[k]), (r["name"], k)
        assert len(r["reward_reps"]) == 2
    assert rows[0][0]["reward_reps"][0] != rows[0][0]["reward_reps"][1]
    for k, v in tckpt.fleet_flat(fleet).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_restored_fleet_scores_identically(fleet, tmp_path):
    """``load_fleet`` of a saved checkpoint scores as the fleet itself."""
    cfg = TCfg()
    tckpt.save(str(tmp_path), 3, fleet)
    loaded = tlb.load_fleet(cfg, str(tmp_path), n_agents=2, device="cpu")
    cell = CELLS[:1]
    assert tlb.run_leaderboard(cfg, loaded, cell, **SMALL) == \
        tlb.run_leaderboard(cfg, fleet, cell, **SMALL)
    with pytest.raises(FileNotFoundError, match="no checkpoint manifests"):
        tlb.load_fleet(cfg, str(tmp_path / "empty"), n_agents=2,
                       device="cpu")


def gate_rows():
    base = {"agents": 2, "episodes": 2, "eval_intervals": 4,
            "replicates": 1, "seed": 0}
    rows = [dict(base, name="a", reward_mean=0.50, eval_eff_mean=10.0,
                 eval_p99_mean=0.3, eval_slo_mean=0.9,
                 fl_payload_bytes=9000.0),
            dict(base, name="b", reward_mean=0.01, eval_eff_mean=5.0,
                 eval_p99_mean=0.5, eval_slo_mean=0.8,
                 fl_payload_bytes=9000.0),
            dict(base, name="c", reward_mean=-0.2, eval_eff_mean=2.0),
            dict(base, name="new", reward_mean=0.1, eval_eff_mean=1.0)]
    prev = [dict(base, name="a", reward_mean=0.70, eval_eff_mean=10.5,
                 eval_p99_mean=0.2, eval_slo_mean=0.95,
                 fl_payload_bytes=9000.0),
            dict(base, name="b", reward_mean=0.03, eval_eff_mean=5.6,
                 eval_p99_mean="torn", eval_slo_mean=float("nan")),
            dict(base, name="c", episodes=6, reward_mean=0.9)]
    return rows, {"results": prev}


@pytest.mark.parametrize("tol,tolerances", [
    (0.10, None), (0.5, None), (0.10, {"a": 0.4})])
def test_gate_functions_match_jax(tol, tolerances):
    """``attach_deltas`` and ``check_regressions`` on the same rows and
    envelope (unstamped: legacy envelopes pass both packages' backend
    check) give JAX's rows, warnings and failures."""
    out = []
    for mod in (tlb, jlb):
        rows, env = gate_rows()
        warns = []
        rows = mod.attach_deltas(rows, copy.deepcopy(env), warn=warns.append)
        out.append((rows, warns, mod.check_regressions(
            rows, tol=tol, tolerances=tolerances)))
    assert out[0] == out[1]
    assert out[0][2] or tol == 0.5
    for bad in (None, [], {"results": "x"}, "garbage"):
        assert tlb.sanitize_envelope(bad) is None
        assert jlb.sanitize_envelope(bad) is None


def test_sanitize_refuses_cross_backend_envelopes():
    """The port stamps ``torch:cpu`` / ``torch:cuda``: a JAX envelope (any
    of its backends) is refused, the port's own accepted, an unstamped
    one passes."""
    stamp = tlb.backend_stamp()
    other = "torch:cpu" if torch.cuda.is_available() else "torch:cuda"
    assert stamp["backend"] in ("torch:cpu", "torch:cuda")
    rows, env = gate_rows()
    for jax_backend in ("cpu", "gpu", "tpu"):
        warns = []
        assert tlb.sanitize_envelope(dict(env, backend=jax_backend,
                                          device_count=1),
                                     warn=warns.append) is None
        assert "refusing the cross-backend diff" in warns[0]
    assert tlb.sanitize_envelope(dict(env, **stamp)) is not None
    assert tlb.sanitize_envelope(dict(env, backend=other,
                                      device_count=1)) is None
    assert tlb.sanitize_envelope(env) is env
    refused = tlb.attach_deltas(rows, dict(env, backend="cpu"))
    assert not any(k.startswith("prev_") for r in refused for k in r)


def test_cell_from_jax_draws_lies_in_jax_row():
    """One cell (steady, fluid, int8: two episodes with a round, eight
    held-out intervals) scored by JAX and by the port from JAX's fleet and
    JAX's draws: every metric of the row within the band."""
    cell_j, cell_t = jlb.Cell("steady", "fluid", "int8"), \
        tlb.Cell("steady", "fluid", "int8")
    cfg_j, cfg_t = JCfg(), TCfg()
    a, eps, n_int = 4, 2, 8
    jf = jfleet.fleet_init(cfg_j, a, jax.random.PRNGKey(3))
    want = jlb.evaluate_cell(cfg_j, jf, cell_j, episodes=eps,
                             eval_intervals=n_int, replicates=1, seed=0)

    def draws(r):
        s = jlb.cell_seed(0, cell_j, r)
        rngs, noise = jf.astate.rng, []
        for _ in range(eps):
            g, rngs = jax_episode_noise(rngs, cfg_j.n_steps,
                                        head_sizes(cfg_j))
            noise.append(np.asarray(g))
        return dict(
            traces=np.array(j_make_scenario(
                "steady", jax.random.PRNGKey(s), a, eps * cfg_j.n_steps)),
            gumbel=torch.tensor(np.stack(noise)),
            eval_traces=np.array(j_make_scenario(
                "steady", jax.random.PRNGKey(jlb.cell_seed(0, cell_j, r,
                                                           "eval")),
                a, n_int)),
            eval_gumbel=torch.tensor(np.asarray(jax_sim_noise(
                jax.random.PRNGKey(jlb.cell_seed(0, cell_j, r, "key")),
                n_int, a, head_sizes(cfg_j)))))

    tf = tfleet.fleet_from_numpy(cfg_t, jax_fleet_tree(jf), device="cpu")
    got = tlb.evaluate_cell(cfg_t, tf, cell_t, episodes=eps,
                            eval_intervals=n_int, replicates=1, seed=0,
                            draws=draws)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, str) or isinstance(v, int):
            assert got[k] == v, k
        else:
            close(np.asarray(got[k], np.float64), np.asarray(v), k)
    assert want["fl_payload_bytes"] > 0 and want["eval_eff_mean"] > 0
