"""The metrics stream of the PyTorch port (``repro_torch.eval.stream``,
``launch/watch.py``, ``health/alerts.py``), its taps in both fleet drivers,
the trainer CLI's health and stream flags, resume with health and a
stream, and health checkpoints between the packages, on the CPU.

The host-side modules are copies of the JAX package's: the same inputs
give the same files, records, summaries, rendered text and alert lines.
The drivers' records equal their returned histories (absolute episodes,
the JAX run's keys); a killed and resumed ``--health --metrics-out`` run
equals the straight run bit for bit, the health state and the episode
records included.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import fleet as jfleet
from repro.eval import stream as jstream
from repro import health as jh
from repro.health import alerts as jalerts
from repro.launch import train_fleet as jax_cli
from repro.launch import watch as jwatch
from repro.training import checkpoint as jckpt
from repro_torch import health as th
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import fleet as tfleet
from repro_torch.eval import stream as tstream
from repro_torch.fl import transport as ttr
from repro_torch.health import alerts as talerts
from repro_torch.launch import train_fleet as train_cli
from repro_torch.launch import watch as twatch
from repro_torch.resilience import faults as tfaults
from repro_torch.training import checkpoint as tckpt

CFG_T = TCfg(fl_every=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ListSink:
    def __init__(self):
        self.records, self.closed = [], False

    def append(self, r):
        self.records.append(r)

    def close(self):
        self.closed = True


def records_file(path, rows, meta=None):
    with tstream.MetricsSink(str(path), meta=meta or {"agents": 2}) as sink:
        for r in rows:
            sink.append(r)


def sample_rows(n=12, health_from=4):
    rng = np.random.default_rng(0)
    rows = []
    for e in range(n):
        r = {"episode": e, "reward": float(rng.uniform(-1, 0)),
             "throughput": float(rng.uniform(10, 90)),
             "fl_payload_bytes": float(27432.0 * (e % 2)),
             "fl_uplink_s": 0.001, "fl_missed": float(e % 3 == 0),
             "fl_stale_used": 0.0, "fl_rejected": 0.0, "fl_clipped": 0.0}
        if e >= health_from:
            r.update(health_reward_p50=float(rng.uniform(-1, 0)),
                     health_miss_p90=float(rng.uniform(0.5, 1.0)),
                     health_drift_score=float(rng.uniform(0, 2)),
                     health_drift_flag=float(e % 5 == 0),
                     health_susp=float(rng.uniform(0, 0.9)),
                     health_act_entropy=2.0)
        rows.append(r)
    return rows


# ---------------------------------------------------------------------------
# The host-side modules against the JAX package's
# ---------------------------------------------------------------------------
def test_metrics_sink_writes_jax_files(tmp_path):
    """The same records through both sinks: the same bytes; the readers
    and every summary agree."""
    rows = sample_rows()
    paths = []
    for mod, name in ((tstream, "t"), (jstream, "j")):
        path = tmp_path / f"{name}.jsonl"
        with mod.MetricsSink(str(path), meta={"agents": 2, "seed": 0}) as s:
            for r in rows:
                s.append(r)
            assert s.n_records == len(rows)
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    meta, recs = tstream.read_metrics(str(paths[0]))
    assert (meta, recs) == jstream.read_metrics(str(paths[0]))
    for fn in ("tail_summary", "health_summary", "fl_round_summary",
               "device_summary"):
        assert getattr(tstream, fn)(recs) == getattr(jstream, fn)(recs), fn
    assert tstream.health_summary(recs[:3]) is None


def test_metrics_sink_resume_and_torn_tail(tmp_path):
    """``resume=True`` appends after a torn last line (repaired with a
    newline), keeps the records before it, refuses a meta mismatch and a
    file without a header, and starts a fresh file when there is none —
    as the JAX sink does, byte for byte."""
    rows = sample_rows(6)
    for mod, name in ((tstream, "t"), (jstream, "j")):
        path = tmp_path / f"{name}.jsonl"
        records_file(path, rows[:4], meta={"agents": 2, "seed": 1})
        with open(path, "a") as f:
            f.write('{"episode": 4, "rew')           # killed mid-append
        with mod.MetricsSink(str(path), meta={"agents": 2, "seed": 1},
                             resume=True) as s:
            assert s.n_records == 4
            s.append(rows[4])
        with pytest.raises(ValueError, match="meta mismatch on 'seed'"):
            mod.MetricsSink(str(path), meta={"seed": 2}, resume=True)
        bad = tmp_path / f"{name}-bad.jsonl"
        bad.write_text('{"episode": 0}\n')
        with pytest.raises(ValueError, match="no parseable meta header"):
            mod.MetricsSink(str(bad), meta={}, resume=True)
        fresh = tmp_path / f"{name}-fresh.jsonl"
        mod.MetricsSink(str(fresh), meta={"a": 1}, resume=True).close()
        assert fresh.read_text() == '{"a": 1, "kind": "meta"}\n'
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
    _, recs = tstream.read_metrics(str(tmp_path / "t.jsonl"))
    assert [r["episode"] for r in recs] == [0, 1, 2, 3, 4]


def test_alert_engine_lines_equal_jax(tmp_path):
    """The default rulebook and a custom one over the same stream: the
    alerts files are JAX's line for line, and both tees forward every
    record."""
    rows = sample_rows(40, health_from=0)
    for r in rows[10:18]:
        r["health_reward_p50"] = -0.9
    rules = (*talerts.DEFAULT_RULES,
             talerts.AlertRule("hot", "throughput", "gt", 50.0, 2, "info"))
    jrules = (*jalerts.DEFAULT_RULES,
              jalerts.AlertRule("hot", "throughput", "gt", 50.0, 2, "info"))
    assert [vars(r) for r in talerts.DEFAULT_RULES] == \
        [vars(r) for r in jalerts.DEFAULT_RULES]
    out = []
    for mod, rl, name in ((talerts, rules, "t"), (jalerts, jrules, "j")):
        sink = ListSink()
        path = tmp_path / f"{name}.jsonl"
        with mod.AlertEngine(str(path), rules=rl, forward=sink) as eng:
            for r in rows:
                eng.append(r)
            eng.append({"devices": 1.0})
        assert sink.records == [*rows, {"devices": 1.0}]
        out.append((path.read_text().splitlines(), eng.n_alerts))
    assert out[0] == out[1]
    assert out[0][1] > 0
    assert talerts.read_alerts(str(tmp_path / "t.jsonl")) == \
        jalerts.read_alerts(str(tmp_path / "t.jsonl"))
    for kw in (dict(op="ge"), dict(severity="loud"), dict(window=0)):
        args = {**dict(name="x", metric="m", op="gt", threshold=0.0), **kw}
        with pytest.raises(ValueError) as want:
            jalerts.AlertRule(**args)
        with pytest.raises(ValueError) as got:
            talerts.AlertRule(**args)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["full", "no-health", "meta-only", "torn"])
def test_watch_render_equals_jax(tmp_path, case, capsys):
    """``render`` (and ``main``'s printout) of the same file: JAX's text,
    with and without health records, alerts and a scaling row."""
    path = tmp_path / "run.jsonl"
    rows = sample_rows(12, health_from=0 if case == "full" else 99)
    if case == "meta-only":
        rows = []
    records_file(path, rows)
    if case != "meta-only":
        with open(path, "a") as f:
            f.write(json.dumps({"devices": 1.0, "agents": 2.0,
                                "step_time_s": 0.004,
                                "dev0_bytes": 9000.0}) + "\n")
    if case == "torn":
        with open(path, "a") as f:
            f.write('{"episode": 12, "rew')
    apath = tmp_path / "alerts.jsonl"
    with talerts.AlertEngine(str(apath)) as eng:
        for r in rows:
            eng.append(r)
    for k in (3, 10):
        for alerts in (None, str(apath), str(tmp_path / "none.jsonl")):
            assert twatch.render(str(path), k, alerts_path=alerts) == \
                jwatch.render(str(path), k, alerts_path=alerts)
    printed = []
    for mod in (twatch, jwatch):
        mod.main([str(path), "--alerts", str(apath)])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert twatch.WATCH_METRICS == jwatch.WATCH_METRICS


# ---------------------------------------------------------------------------
# The drivers' taps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("health", [False, True], ids=["plain", "health"])
def test_stream_records_equal_the_history(health):
    """Both drivers stream one record per episode, ``{"episode":
    absolute episode, **history values}``, equal to the returned history
    (float32 values), with the keys of JAX's stream for the same run; a
    second call continues at its ``episode_offset``."""
    a, n = 4, 5
    traces = torch.tensor(np.random.default_rng(1).uniform(
        5.0, 160.0, (a, n * 10)).astype(np.float32))
    kw = dict(transport=ttr.TransportConfig(codec="int8"),
              faults=tfaults.FaultConfig(byzantine_frac=0.25),
              health=th.HealthConfig() if health else None)
    runs = []
    for drive in (tfleet.train_fleet_scan, tfleet.train_fleet_reference):
        sink = ListSink()
        fleet = tfleet.fleet_init(CFG_T, a, 2, n_pods=2, device="cpu")
        fleet, h1 = drive(CFG_T, fleet, traces[:, :30], metrics_sink=sink,
                          total_episodes=n, **kw)
        fleet, h2 = drive(CFG_T, fleet, traces[:, 30:], metrics_sink=sink,
                          episode_offset=3, total_episodes=n, **kw)
        hist = {k: np.concatenate([h1[k], h2[k]]).astype(np.float32)
                for k in h1}
        assert [r["episode"] for r in sink.records] == list(range(n))
        for i, rec in enumerate(sink.records):
            assert set(rec) == {"episode", *hist}
            for k, v in hist.items():
                assert np.float32(rec[k]) == v[i], (k, i)
        runs.append(sink.records)
    assert runs[0] == runs[1]
    jsink = ListSink()
    jkw = dict(health=jh.HealthConfig()) if health else {}
    jfleet.train_fleet_scan(
        JCfg(fl_every=1), jfleet.fleet_init(JCfg(fl_every=1), 2,
                                            jax.random.PRNGKey(0)),
        jnp.ones((2, 10)) * 50.0, metrics_sink=jsink, **jkw)
    assert set(jsink.records[0]) == set(runs[0][0])


def test_sink_off_changes_nothing():
    """The graph driver with and without a sink: the same history and
    state bit for bit."""
    traces = torch.full((4, 30), 60.0)
    outs = []
    for sink in (None, ListSink()):
        fleet = tfleet.fleet_init(CFG_T, 4, 3, n_pods=2, device="cpu")
        fleet, hist = tfleet.train_fleet_scan(CFG_T, fleet, traces,
                                              metrics_sink=sink)
        outs.append((hist, tckpt.fleet_flat(fleet)))
    for k, v in outs[0][0].items():
        np.testing.assert_array_equal(outs[1][0][k], v, err_msg=k)
    for k, v in outs[0][1].items():
        np.testing.assert_array_equal(outs[1][1][k], v, err_msg=k)


# ---------------------------------------------------------------------------
# The CLI: flags, errors, resume, the scaling record
# ---------------------------------------------------------------------------
HEALTH_ARGV = ["--device", "cpu", "--agents", "4", "--pods", "2",
               "--fl-every", "1", "--fl-codec", "int8",
               "--fault-byzantine-frac", "0.25", "--health",
               "--susp-threshold", "0.5"]


@pytest.mark.parametrize("argv", [
    ["--susp-threshold", "0.5"], ["--alerts-out", "a.jsonl"],
    ["--health-bins", "10"]])
def test_cli_health_flag_errors_match_jax(argv, capsys):
    """The new flags without ``--health`` fail as the JAX CLI's do."""
    errors = []
    for cli in (jax_cli, train_cli):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--episodes", "1", *argv])
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split("error: ")[1] == errors[1].split("error: ")[1]


@pytest.mark.parametrize("driver", ["scan", "reference"])
def test_cli_health_stream_and_alerts(tmp_path, driver, capsys):
    """``--health --metrics-out --alerts-out`` under each driver: the file
    holds the history's records and the trailing scaling record (one
    device, ``dev0_bytes``, the state bytes per agent with health), the
    alerts file JAX's engine would write from those records, the health
    line printed; ``--health-bins 10`` gives ten-bin histograms."""
    out = tmp_path / "run.jsonl"
    alerts = tmp_path / "alerts.jsonl"
    fleet, hist = train_cli.main([
        *HEALTH_ARGV, "--episodes", "5", "--driver", driver,
        "--health-bins", "10", "--metrics-out", str(out),
        "--alerts-out", str(alerts)])
    text = capsys.readouterr().out
    assert "health: drift flags on" in text and "alerts ->" in text
    meta, recs = tstream.read_metrics(str(out))
    assert meta["driver"] == driver and meta["agents"] == 4
    assert len(recs) == 6 and "devices" in recs[-1]
    for i, rec in enumerate(recs[:-1]):
        assert rec["episode"] == i
        for k, v in hist.items():
            assert np.float32(rec[k]) == np.float32(v[i]), k
    row = recs[-1]
    assert row["devices"] == 1.0 and row["dev0_bytes"] > 0
    assert row["state_bytes_per_agent"] == \
        tfleet.fleet_state_bytes(fleet)["per_agent"]
    assert fleet.health.reward_hist.shape == (4, 10)
    jfile = tmp_path / "j.jsonl"
    with jalerts.AlertEngine(str(jfile)) as eng:
        for r in recs:
            eng.append(r)
    assert alerts.read_text() == jfile.read_text()
    assert twatch.render(str(out), 10, alerts_path=str(alerts)) == \
        jwatch.render(str(out), 10, alerts_path=str(alerts))


def test_cli_resume_with_health_and_stream(tmp_path):
    """``--health --metrics-out --ckpt-every 2`` killed by ``--stop-after
    3`` and rerun: the two invocations' histories, the final checkpoint
    (health state and generators included) and the episode records are
    the straight run's bit for bit; the file's records continue at episode
    3 after a resume line."""
    argv = [*HEALTH_ARGV, "--episodes", "6", "--ckpt-every", "2"]
    _, h_s = train_cli.main([*argv, "--ckpt-dir", str(tmp_path / "a"),
                             "--metrics-out", str(tmp_path / "a.jsonl")])
    killed = [*argv, "--ckpt-dir", str(tmp_path / "b"),
              "--metrics-out", str(tmp_path / "b.jsonl")]
    _, h_1 = train_cli.main([*killed, "--stop-after", "3"])
    assert tckpt.latest_step(str(tmp_path / "b")) == 3
    _, recs = tstream.read_metrics(str(tmp_path / "b.jsonl"))
    assert [r.get("episode") for r in recs] == [0, 1, 2, None]
    _, h_2 = train_cli.main(killed)
    for k, v in h_s.items():
        np.testing.assert_array_equal(np.concatenate([h_1[k], h_2[k]]), v,
                                      err_msg=k)
    with np.load(tmp_path / "a" / "step_00000006.npz") as a, \
            np.load(tmp_path / "b" / "step_00000006.npz") as b:
        assert set(a.files) == set(b.files)
        assert any(k.startswith("13/") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ep = lambda path: [r for r in tstream.read_metrics(str(path))[1]
                       if "episode" in r]
    assert ep(tmp_path / "a.jsonl") == ep(tmp_path / "b.jsonl")
    assert [r["episode"] for r in ep(tmp_path / "b.jsonl")] == list(range(6))


# ---------------------------------------------------------------------------
# Health checkpoints between the packages
# ---------------------------------------------------------------------------
def test_health_checkpoint_passes_between_the_packages(tmp_path):
    """A JAX health fleet's checkpoint restores in the port (every health
    leaf equal, JAX's key paths), and the port's restores in JAX; a
    checkpoint without health restores a health fleet without it, and the
    driver attaches fresh state."""
    cfg_j = JCfg(fl_every=1)
    hj = jh.HealthConfig()
    jf = jfleet.fleet_init(cfg_j, 4, jax.random.PRNGKey(0), n_pods=2,
                           health=hj)
    jf, _ = jfleet.train_fleet_scan(cfg_j, jf, jnp.full((4, 20), 70.0),
                                    health=hj)
    jckpt.save(str(tmp_path / "j"), 2, jf)
    like = tfleet.fleet_init(CFG_T, 4, 0, n_pods=2, device="cpu",
                             health=th.HealthConfig())
    tf, _ = tckpt.restore(str(tmp_path / "j"), 2, like, CFG_T)
    want = jckpt._flatten(jf)
    flat = tckpt.fleet_flat(tf)
    health_keys = [k for k in want if k.startswith("13/")]
    assert len(health_keys) == 37
    assert set(health_keys) <= set(flat)
    for k in health_keys:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    assert float(tf.health.n_obs[0]) == 20.0

    tf, _ = tfleet.train_fleet_scan(CFG_T, tf, torch.full((4, 10), 70.0),
                                    health=th.HealthConfig(),
                                    episode_offset=2, total_episodes=3)
    tckpt.save(str(tmp_path / "t"), 3, tf)
    back, _ = jckpt.restore(str(tmp_path / "t"), 3, jf)
    flat = tckpt.fleet_flat(tf)
    for k, v in jckpt._flatten(back).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)

    plain = tfleet.fleet_init(CFG_T, 4, 0, n_pods=2, device="cpu")
    tckpt.save(str(tmp_path / "p"), 1, plain)
    restored, _ = tckpt.restore(str(tmp_path / "p"), 1, like, CFG_T)
    assert restored.health is None
    restored, _ = tfleet.train_fleet_scan(CFG_T, restored,
                                          torch.full((4, 10), 70.0),
                                          health=th.HealthConfig())
    assert float(restored.health.n_obs[0]) == 10.0
    shutil.rmtree(tmp_path / "j")
