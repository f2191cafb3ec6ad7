"""The flight recorder's span layer and profile layer of the port on the CPU.

``repro_torch.obs.trace`` against ``repro.obs.trace``: the Chrome schema
(export round-trip, the validator on every case, unmatched and open
spans); the drivers' spans (JAX's A=4, four-episode fixture: names,
counts, nesting and sampling under both of the port's drivers, against
JAX's traced scan); tracing moves no bit (traced == untraced in the port,
and within rtol 1e-4 / atol 1e-5 of JAX's UNTRACED run: under jax 0.9.0
JAX's traced run departs from its own untraced run by a float32 ulp, so
the port is held against the untraced one); the traced bodies dispatch
the untraced ops; kernel spans (top level, opt-in; K2 inside
``fl/encode``); the CLI's ``--trace-out`` / ``--trace-sample``; and
``repro_torch.obs.profile`` (the in-place audit, the state bytes, the
kernels' counts from their shapes).
"""
import json
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import fleet as jfleet
from repro.obs import trace as jtrace
from repro.sim import make_scenario as j_make_scenario
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import fleet as tfleet
from repro_torch.core.graphs import GraphedBody
from repro_torch.fl.transport import TransportConfig
from repro_torch.kernels.span_stamp import span_stamp, span_stamp_ref
from repro_torch.launch import train_fleet as train_cli
from repro_torch.obs import profile as tprof
from repro_torch.obs import trace as ttrace
from test_torch_support import (close, head_sizes, jax_episode_noise,
                                jax_fleet_tree)

A, EPISODES, SEED = 4, 4, 0
DRIVERS = {"scan": tfleet.train_fleet_scan,
           "reference": tfleet.train_fleet_reference}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(tree, prefix=""):
    """(dotted name, numpy leaf) of a nested dict (``fleet_to_numpy``)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def x_counts(events):
    return Counter(e["name"] for e in events if e["ph"] == "X")


# ---------------------------------------------------------------------------
# Chrome trace-event schema
# ---------------------------------------------------------------------------
def test_export_roundtrip(tmp_path):
    tr = ttrace.Tracer(pid=7)
    with tr.span("compile", cat="host"):
        with tr.span("lower", cat="host"):
            pass
    tr.instant("ckpt-written")
    tr.add_complete("req0/infer", ts_us=10.0, dur_us=5.0, pid=1000, tid=2,
                    args={"agent": 0})
    path = tr.export(str(tmp_path / "trace.json"))
    tr.close()
    with open(path) as f:
        trace = json.load(f)
    assert ttrace.validate_chrome_trace(trace) == []
    assert jtrace.validate_chrome_trace(trace) == []
    ev = trace["traceEvents"]
    assert {e["name"] for e in ev} == {"compile", "lower", "ckpt-written",
                                        "req0/infer"}
    inner = next(e for e in ev if e["name"] == "lower")
    outer = next(e for e in ev if e["name"] == "compile")
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    req = next(e for e in ev if e["name"] == "req0/infer")
    assert (req["pid"], req["tid"], req["args"], req["cat"]) == \
        (1000, 2, {"agent": 0}, "request")


OK_EVENT = {"name": "a", "ph": "X", "ts": 0.0, "dur": 1.0, "pid": 1,
            "tid": 0}
VALIDATOR_CASES = {
    "list": [1, 2],
    "no-events": {"nope": []},
    "events-not-list": {"traceEvents": "x"},
    "ok": {"traceEvents": [OK_EVENT]},
    "missing-key": {"traceEvents": [{k: v for k, v in OK_EVENT.items()
                                     if k != "pid"}]},
    "unknown-phase": {"traceEvents": [dict(OK_EVENT, ph="Z")]},
    "negative-ts": {"traceEvents": [dict(OK_EVENT, ts=-1.0)]},
    "x-without-dur": {"traceEvents": [{k: v for k, v in OK_EVENT.items()
                                       if k != "dur"}]},
    "negative-dur": {"traceEvents": [dict(OK_EVENT, dur=-2.0)]},
    "not-an-object": {"traceEvents": ["not-an-object"]},
    "instant": {"traceEvents": [{"name": "m", "ph": "i", "ts": 3, "s": "t",
                                 "pid": 1, "tid": 0}]},
}


@pytest.mark.parametrize("case", sorted(VALIDATOR_CASES))
def test_validator_agrees_with_jax(case):
    trace = VALIDATOR_CASES[case]
    got = ttrace.validate_chrome_trace(trace)
    assert got == jtrace.validate_chrome_trace(trace)
    assert (got == []) == (case in ("ok", "instant"))
    assert ttrace.REQUIRED_KEYS == jtrace.REQUIRED_KEYS
    assert ttrace.VALID_PH == jtrace.VALID_PH


def strip_ts(events):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def test_interrupted_and_unmatched_spans_as_jax():
    """An open span drains as an ``-open`` instant; an end that skips
    stack levels closes the inner spans; an unmatched end is an instant:
    the same events (timestamps aside) as JAX's tracer."""
    runs = []
    for mod in (ttrace, jtrace):
        tr = mod.Tracer()
        tr._begin("episode", "phase")
        tr._begin("fl_round", "phase")
        tr._begin("fl/uplink", "phase")
        tr._end("fl_round")            # closes fl/uplink and fl_round
        tr._end("pod_merge")           # unmatched: closes episode, instant
        tr._begin("episode", "phase")  # never ended: drains as -open
        trace = tr.chrome_trace()
        tr.close()
        assert mod.validate_chrome_trace(trace) == []
        runs.append(trace["traceEvents"])
    assert sorted(map(str, strip_ts(runs[0]))) == \
        sorted(map(str, strip_ts(runs[1])))
    assert {e["cat"] for e in runs[0]} >= {"phase-open", "unmatched-end"}


def test_sample_period_must_be_positive():
    with pytest.raises(ValueError, match="span_sample_every"):
        ttrace.Tracer(span_sample_every=0)


# ---------------------------------------------------------------------------
# The drivers' spans: JAX's A=4, four-episode fixture
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def traced_runs():
    cfg = JCfg()
    jf0 = jfleet.fleet_init(cfg, A, jax.random.PRNGKey(SEED))
    traces = np.asarray(j_make_scenario(
        "nominal", jax.random.PRNGKey(SEED + 1), A, EPISODES * cfg.n_steps))
    kw = dict(seed=SEED, donate=False)
    _, j_off = jfleet.train_fleet_scan(cfg, jf0, jnp.asarray(traces), **kw)
    jt = jtrace.Tracer()
    jfleet.train_fleet_scan(cfg, jf0, jnp.asarray(traces), tracer=jt, **kw)
    j_events = jt.chrome_events()
    jt.close()
    rngs, noise = jf0.astate.rng, []
    for _ in range(EPISODES):
        g, rngs = jax_episode_noise(rngs, cfg.n_steps, head_sizes(cfg))
        noise.append(np.asarray(g))
    gumbel = torch.tensor(np.stack(noise))
    tree = jax_fleet_tree(jf0)
    runs = {}
    for name, drive in DRIVERS.items():
        for every in (None, 1, 2):
            tr = None if every is None else ttrace.Tracer(
                span_sample_every=every)
            fleet = tfleet.fleet_from_numpy(TCfg(), tree, device="cpu")
            fleet, hist = drive(TCfg(), fleet, torch.tensor(traces),
                                seed=SEED, gumbel=gumbel, tracer=tr)
            runs[name, every] = (hist, tfleet.fleet_to_numpy(fleet),
                                 None if tr is None else tr.chrome_events())
    return {"j_off": j_off, "j_events": j_events, "runs": runs}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_span_names_and_counts(traced_runs, driver):
    """JAX's counts (``tests/test_obs.py``): four episodes, two rounds
    (``fl_every=2``), each with uplink, aggregate and finetune under the
    graph driver; the reference driver's host spans are the episode and
    the round, as JAX's reference driver takes them. No unmatched or open
    span."""
    events = traced_runs["runs"][driver, 1][2]
    counts = x_counts(events)
    assert counts["episode"] == EPISODES
    assert counts["fl_round"] == 2
    if driver == "scan":
        assert counts == x_counts(traced_runs["j_events"])
        for phase in ("fl/uplink", "fl/aggregate", "fl/finetune"):
            assert counts[phase] == 2, counts
    else:
        assert set(counts) == {"episode", "fl_round"}
    assert not [e for e in events if e.get("cat", "").endswith("-open")
                or e.get("cat") == "unmatched-end"]
    assert ttrace.validate_chrome_trace({"traceEvents": events}) == []


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_spans_monotone_and_nested(traced_runs, driver):
    ev = [e for e in traced_runs["runs"][driver, 1][2] if e["ph"] == "X"]
    eps = sorted((e for e in ev if e["name"] == "episode"),
                 key=lambda e: e["ts"])
    for prev, nxt in zip(eps, eps[1:]):
        assert nxt["ts"] >= prev["ts"] + prev["dur"]
    rounds = [e for e in ev if e["name"] == "fl_round"]
    for e in ev:
        if e["name"].startswith("fl/"):
            assert any(r["ts"] <= e["ts"] and
                       e["ts"] + e["dur"] <= r["ts"] + r["dur"]
                       for r in rounds), (e, rounds)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_sampling_thins_emission(traced_runs, driver):
    """``span_sample_every=2`` keeps episodes 0 and 2; the rounds land on
    the sampled-out episodes 1 and 3, so no round spans at all."""
    counts = x_counts(traced_runs["runs"][driver, 2][2])
    assert counts["episode"] == EPISODES // 2
    assert counts["fl_round"] == 0 and set(counts) == {"episode"}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_traced_run_is_the_untraced_run_bit_for_bit(traced_runs, driver):
    runs = traced_runs["runs"]
    hist0, state0, _ = runs[driver, None]
    for every in (1, 2):
        hist, state, _ = runs[driver, every]
        for k, v in hist0.items():
            np.testing.assert_array_equal(hist[k], v, err_msg=k)
        want, got = dict(leaves(state0)), dict(leaves(state))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_traced_run_in_band_of_jax_untraced(traced_runs, driver):
    hist = traced_runs["runs"][driver, 1][0]
    for k, v in hist.items():
        close(v, traced_runs["j_off"][k], k)


@pytest.mark.parametrize("backend", ["fluid", "twin"])
def test_traced_bodies_dispatch_the_untraced_ops(backend):
    """The graph driver's episode and round bodies (int8: the encode site
    and the codec's kernel span run) dispatch the same ops with a tracer
    as without one: spans are host work on the CPU and stamp kernels
    (``ctypes``, not dispatched) on the card."""
    cfg = TCfg(fl_every=1)
    gen = torch.Generator().manual_seed(1)
    traces = torch.rand((4, 4 * cfg.n_steps), generator=gen) * 100 + 5
    counts = []
    for tracer in (None, ttrace.Tracer()):
        driver = tfleet.FleetScan(
            cfg, tfleet.fleet_init(cfg, 4, 0, n_pods=2, device="cpu",
                                   env_backend=backend), traces,
            env_backend=backend, transport=TransportConfig(codec="int8"),
            tracer=tracer)
        driver.step()
        ops = []
        for body in (driver._episode, driver._round):
            with tprof.OpBytes() as c:
                body()
            ops.append(c.ops)
        counts.append(ops)
        if tracer is not None:
            assert x_counts(tracer.chrome_events())["kernel/delta_codec"] == 2
    assert counts[0] == counts[1]


def test_kernel_span_nests_in_the_encode_phase():
    cfg = TCfg(fl_every=1)
    traces = torch.full((4, 2 * cfg.n_steps), 40.0)
    tr = ttrace.Tracer()
    tfleet.train_fleet_scan(cfg, tfleet.fleet_init(cfg, 4, 0, device="cpu"),
                            traces, transport=TransportConfig(codec="topk"),
                            tracer=tr)
    ev = [e for e in tr.chrome_events() if e["ph"] == "X"]
    enc = [e for e in ev if e["name"] == "fl/encode"]
    ker = [e for e in ev if e["name"] == "kernel/delta_codec"]
    assert len(enc) == len(ker) == 2
    for k, e in zip(sorted(ker, key=lambda x: x["ts"]),
                    sorted(enc, key=lambda x: x["ts"])):
        assert e["ts"] <= k["ts"] and k["ts"] + k["dur"] <= e["ts"] + e["dur"]
        assert k["cat"] == "kernel"


def test_kernel_spans_opt_in():
    """A wrapper records only under an active ``kernel_spans`` tracer, and
    returns the same values; a captured body's kernels record nothing."""
    from repro_torch.kernels.packing import pack
    tok = torch.ones((16, 8))
    idx = torch.tensor([0, 3, -1, 5], dtype=torch.int32)
    base = pack(tok, idx)
    with ttrace.Tracer(kernel_spans=True) as tr, ttrace.activate(tr):
        out = pack(tok, idx)
        GraphedBody(lambda: pack(tok, idx), torch.device("cpu"))()
    assert [e["name"] for e in tr.chrome_events() if e["ph"] == "X"] == \
        ["kernel/pack"]
    assert torch.equal(base, out)
    with ttrace.Tracer(kernel_spans=False) as quiet, ttrace.activate(quiet):
        pack(tok, idx)
    assert quiet.chrome_events() == []


def test_top_level_kernel_spans_are_not_sampled():
    """Episode sampling does not thin top-level kernel spans: each call of
    each kernel gets its own span, in call order (as in the JAX package)."""
    from repro_torch.kernels.delta_codec import delta_codec
    from repro_torch.kernels.packing import pack
    rng = np.random.default_rng(3)
    tok = torch.tensor(rng.normal(size=(16, 8)).astype(np.float32))
    idx = torch.tensor([0, 3, -1, 5], dtype=torch.int32)
    d = torch.tensor(rng.normal(size=(2, 12)).astype(np.float32))
    with ttrace.Tracer(span_sample_every=2, kernel_spans=True) as tr, \
            ttrace.activate(tr):
        for _ in range(3):
            pack(tok, idx)
            delta_codec(d, torch.zeros_like(d), codec="int8")
    ev = tr.chrome_events()
    assert [e["name"] for e in ev] == \
        ["kernel/pack", "kernel/delta_codec"] * 3
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(ev, ev[1:]))


def test_span_stamp_plain_rows_and_no_cpu_kernel():
    """The stamp's row arithmetic (the plain version): only sampled
    episodes at or after ``base`` write, at row ``e // k - ceil(base /
    k)``; the kernel itself runs on CUDA only."""
    stamps = torch.zeros((4, 2), dtype=torch.int64)
    every = torch.tensor(3, dtype=torch.int64)
    for e in range(14):
        span_stamp_ref(stamps, torch.tensor(e), every, 1, delta=1, base=2,
                       clock=torch.tensor(100 + e))
    # episodes e + 1 = 3, 6, 9, 12 -> rows 0..3, written by e = 2, 5, 8, 11
    assert stamps[:, 1].tolist() == [102, 105, 108, 111]
    assert stamps[:, 0].tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="CUDA only"):
        span_stamp(stamps, torch.tensor(0), every, 0)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_cli_trace_out(tmp_path, capsys, driver):
    path = tmp_path / "t.json"
    argv = ["--device", "cpu", "--agents", "4", "--episodes", "4",
            "--fl-every", "1", "--fl-codec", "int8", "--driver", driver,
            "--trace-out", str(path), "--trace-sample", "2"]
    _, hist = train_cli.main(argv)
    with open(path) as f:
        trace = json.load(f)
    assert ttrace.validate_chrome_trace(trace) == []
    counts = x_counts(trace["traceEvents"])
    assert counts["episode"] == 2 and counts["fl_round"] == 2
    if driver == "scan":
        assert counts["kernel/delta_codec"] == counts["fl/encode"] == 2
    out = capsys.readouterr().out
    assert f"span events -> {path} (open in Perfetto)" in out
    _, plain = train_cli.main(argv[:-4])
    for k, v in plain.items():
        np.testing.assert_array_equal(hist[k], v, err_msg=k)


def test_cli_trace_sample_must_be_positive(capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--device", "cpu", "--trace-sample", "0"])
    assert "--trace-sample must be >= 1" in capsys.readouterr().err


def test_cli_trace_spans_checkpoint_chunks(tmp_path):
    """A run split by ``--stop-after`` samples by absolute episode: the
    two invocations' traces hold the straight run's episodes."""
    base = ["--device", "cpu", "--agents", "4", "--episodes", "6",
            "--fl-every", "1", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2", "--trace-sample", "2"]
    counts = Counter()
    for i, extra in enumerate((["--stop-after", "3"], [])):
        path = tmp_path / f"t{i}.json"
        train_cli.main(base + extra + ["--trace-out", str(path)])
        with open(path) as f:
            counts.update(x_counts(json.load(f)["traceEvents"]))
    # sampled absolute episodes 0, 2, 4, each with its round
    assert counts["episode"] == 3 and counts["fl_round"] == 3


# ---------------------------------------------------------------------------
# The profile layer
# ---------------------------------------------------------------------------
def test_fleet_memory_report_audit_and_state_bytes():
    cfg = TCfg()
    rep = tprof.fleet_memory_report(cfg, 4, n_pods=2, device="cpu")
    assert set(rep) == {"float32", "lean"}
    for pol, row in rep.items():
        fleet = tfleet.fleet_init(cfg, 4, 0, n_pods=2, device="cpu",
                                  state_policy=pol)
        for k, v in tfleet.fleet_state_bytes(fleet).items():
            assert row[f"state_{k}"] == v, (pol, k)
        assert row["donation_ok"] == 1.0
        assert row["aliased_args"] == row["donated_leaves"] > 100
        assert row["flops"] > 0 and row["bytes_accessed"] > 0
        assert row["peak_bytes"] >= row["argument_size_in_bytes"] + \
            row["output_size_in_bytes"]
        assert row["peak_bytes_per_agent"] == row["peak_bytes"] / 4
        assert row["device"] == "cpu"
    assert rep["lean"]["state_total"] < rep["float32"]["state_total"]


def test_kernel_counts_are_the_tensors_bytes():
    """``kernel_cost``'s bytes equal the bytes of the real arguments and
    results of K1 and K3 (plain versions, on the CPU) at their shapes."""
    from repro_torch.core.buffer import buffer_init
    from repro_torch.kernels.ref import (diversity_insert_ref,
                                         queue_advance_ref)
    from repro_torch.sim.state import SimParams, sim_init
    cfg = TCfg()
    a, t, na = 3, cfg.n_steps, cfg.n_res + cfg.n_bs + cfg.n_mt
    b = buffer_init(cfg, a, "cpu")
    args = (b.states, b.probs, b.score, b.filled, b.s_sum, b.s_outer,
            b.p_sum, b.n_filled, torch.randn(a, t, cfg.state_dim),
            torch.softmax(torch.randn(a, t, na), -1))
    outs = diversity_insert_ref(*args, alpha=cfg.alpha, beta=cfg.beta)
    got = tprof.kernel_cost("diversity_insert", a=a, n=cfg.buffer_size,
                            d=cfg.state_dim, na=na, t=t,
                            flops_per_candidate=1)
    assert got["bytes_accessed"] == tprof.nbytes(*args, *outs)
    assert got["flops"] == a * t
    sp = SimParams()
    state = sim_init(sp, a, "cpu").tensors()
    arr = torch.randint(0, 5, (a, sp.k_ticks), dtype=torch.int32)
    caps = torch.tensor([[2.5, 3.0, 4.0, 2.0, 8.0, 5.0]]).repeat(a, 1)
    for record in (False, True):
        outs = queue_advance_ref(*state, arr, caps, record=record)
        got = tprof.kernel_cost("queue_advance", a=a, ring=sp.ring,
                                hist=sp.hist_n, k=sp.k_ticks, record=record)
        assert got["bytes_accessed"] == tprof.nbytes(*state, arr, caps,
                                                     *outs)
    counts = tprof.profile_kernels()
    assert set(counts) == set(tprof.KERNELS)
    assert counts["flash_attention"]["flops"] == 4 * 2 * 4 * 64 * \
        (128 * 129 // 2)
