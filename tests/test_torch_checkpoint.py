"""Checkpoints and resume of the port (``repro_torch.training.checkpoint``,
``episode_offset`` / ``total_episodes`` in both drivers, the CLI's
``--ckpt-dir`` family) against the JAX package's format, on the CPU.

A checkpoint round-trips exactly under every policy, leaf dtypes and the
generators' states included; either package restores the other's, with
equal key sets and every leaf equal bit for bit. A run split at episode 3
of 8 (in one process, through a checkpoint, or through the CLI's
``--stop-after`` and a rerun) equals the uninterrupted run bit for bit
under the chaos flags and under lean. The CLI's new flags fail as the JAX
CLI's do, with its messages.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import fleet as jfleet
from repro.core.backends import TwinBackend as JTwin
from repro.sim.state import SimParams as JSimParams
from repro.training import checkpoint as jckpt
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import fleet as tfleet
from repro_torch.core.backends import TwinBackend
from repro_torch.fl import transport as ttr
from repro_torch.launch import train_fleet as train_cli
from repro_torch.resilience import faults as tfaults
from repro_torch.resilience import guards as tguards
from repro_torch.sim.state import SimParams
from repro_torch.training import checkpoint as ckpt
from test_torch_state_dtype import bits, exact_tree, identical_tree

A, P = 4, 2
CFG_J, CFG_T = JCfg(fl_every=1), TCfg(fl_every=1)
POLICIES = ("float32", "bf16", "lean")
BACKENDS = {"fluid": (None, None),
            "twin": (JTwin(sp=JSimParams()), TwinBackend(sp=SimParams()))}
NOISE = tfaults.FaultConfig(crash_prob=0.2, byzantine_frac=0.3,
                            byzantine_mode="noise", byzantine_scale=2.0,
                            partition_prob=0.5, seed=3)
SIGN = tfaults.FaultConfig(crash_prob=0.2, byzantine_frac=0.3,
                           byzantine_mode="sign_flip", byzantine_scale=5.0,
                           partition_prob=0.5, seed=3)
ROBUST = tguards.GuardConfig(agg="trimmed", trim_frac=0.25, clip_factor=3.0)
ASYNC = ttr.TransportConfig(codec="int8", deadline_s=0.002,
                            async_rounds=True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traces(n_eps, a=A):
    return torch.tensor(np.random.default_rng(1).uniform(
        5.0, 160.0, (a, n_eps * CFG_T.n_steps)).astype(np.float32))


def fresh(policy=None, backend="fluid", seed=0):
    return tfleet.fleet_init(CFG_T, A, seed, n_pods=P, device="cpu",
                             env_backend=BACKENDS[backend][1],
                             state_policy=policy)


def trained(policy, backend, n_eps=2):
    """A port fleet after ``n_eps`` episodes under the chaos flags, so
    that both generators, the timers and the parked deltas are live."""
    fleet, _ = tfleet.train_fleet_scan(
        CFG_T, fresh(policy, backend), traces(n_eps), straggler_prob=0.25,
        seed=7, env_backend=BACKENDS[backend][1], transport=ASYNC,
        faults=NOISE, guards=ROBUST)
    assert fleet.fault_generator is not None
    return fleet


def same_generators(a, b):
    for name in ("generator", "fault_generator"):
        ga, gb = getattr(a, name), getattr(b, name)
        assert (ga is None) == (gb is None), name
        if ga is not None:
            assert torch.equal(ga.get_state(), gb.get_state()), name


# ---------------------------------------------------------------------------
# round trips, within the port and between the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("policy", POLICIES)
def test_round_trip_is_exact_per_policy(tmp_path, policy, backend):
    fleet = trained(policy, backend)
    ckpt.save(str(tmp_path), 2, fleet, extra={"kind": "fleet"})
    assert ckpt.latest_step(str(tmp_path)) == 2
    back, manifest = ckpt.restore(str(tmp_path), 2, fresh(policy, backend),
                                  CFG_T)
    assert manifest["extra"] == {"kind": "fleet"}
    assert manifest["restored_generators"] == ["torch/generator",
                                               "torch/fault_generator"]
    identical_tree(tfleet.fleet_to_numpy(back), tfleet.fleet_to_numpy(fleet))
    np.testing.assert_array_equal(back.rng, fleet.rng)
    assert back.episode == fleet.episode == 2
    same_generators(back, fleet)
    bf16 = [k for k, d in manifest["dtypes"].items() if d == "bfloat16"]
    assert bool(bf16) == (policy != "float32")
    with np.load(tmp_path / "step_00000002.npz") as data:
        assert all(data[k].dtype == np.dtype("V2") for k in bf16)
        assert data["0/.buffer/.actions"].dtype == np.int32
        assert data["0/.rng"].dtype == np.uint32


def test_lean_restores_into_a_float32_fleet(tmp_path):
    """Elastic restore across policies: bf16 leaves widen exactly."""
    lean = trained("lean", "fluid")
    ckpt.save(str(tmp_path), 1, lean)
    back, _ = ckpt.restore(str(tmp_path), 1, fresh(None), CFG_T)
    for name, p in lean.astate.policy.params().items():
        q = back.astate.policy.params()[name]
        assert q.dtype == torch.float32
        assert torch.equal(p.float(), q), name
    assert back.astate.opt["m"]["head_bs.w"].dtype == torch.float32


@pytest.mark.parametrize("policy,backend", [
    ("float32", "fluid"), ("bf16", "fluid"), ("lean", "fluid"),
    ("lean", "twin")])
def test_checkpoints_pass_between_the_packages(tmp_path, policy, backend):
    """A JAX checkpoint restores into the port and a port checkpoint into
    JAX: equal key sets (the port's generator keys aside), every leaf's
    dtype and bits equal, the threefry keys carried through."""
    jb, tb = BACKENDS[backend]
    jf = jfleet.fleet_init(CFG_J, A, jax.random.PRNGKey(0), n_pods=P,
                           env_backend=jb, state_policy=policy)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jckpt.save(str(jdir), 5, jf)
    tf, manifest = ckpt.restore(str(jdir), 5, fresh(policy, backend), CFG_T)
    assert manifest["restored_generators"] == []
    from test_torch_support import jax_fleet_tree
    exact_tree(tfleet.fleet_to_numpy(tf), jax_fleet_tree(jf))
    np.testing.assert_array_equal(tf.rng, np.asarray(jf.astate.rng))
    # ... and back: the port's checkpoint of that fleet, read by JAX
    ckpt.save(str(tdir), 5, tf)
    jback, _ = jckpt.restore(str(tdir), 5, jf)
    j_keys = json.loads((jdir / "step_00000005.json").read_text())["keys"]
    t_keys = json.loads((tdir / "step_00000005.json").read_text())["keys"]
    assert set(j_keys) == {k for k in t_keys if not k.startswith("torch/")}
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jf)[0],
                            jax.tree.leaves(jback)):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=str(path))
    # a trained port fleet with live generators is read by JAX too
    ckpt.save(str(tdir), 6, trained(policy, backend))
    jckpt.restore(str(tdir), 6, jf)


# ---------------------------------------------------------------------------
# hardening (tests/test_checkpoint.py::TestHardening)
# ---------------------------------------------------------------------------
def save_steps(tmp_path, steps):
    fleet = fresh()
    for s in steps:
        ckpt.save(str(tmp_path), s, fleet)
    return fleet


def test_latest_step_skips_broken_npz(tmp_path):
    save_steps(tmp_path, [1, 2])
    (tmp_path / "step_00000002.npz").write_bytes(b"torn write!")
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_latest_step_skips_manifest_without_arrays(tmp_path):
    save_steps(tmp_path, [1, 2])
    (tmp_path / "step_00000002.npz").unlink()       # half-deleted
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_latest_step_skips_garbage_manifest(tmp_path):
    save_steps(tmp_path, [1])
    (tmp_path / "step_00000009.json").write_text("{not json")
    (tmp_path / "step_woops.json").write_text("{}")
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.latest_step(str(tmp_path / "nope")) is None


def test_keep_last_prunes_oldest_complete(tmp_path):
    save_steps(tmp_path, [1, 2, 3, 4, 5])
    assert ckpt.keep_last(str(tmp_path), 3) == 2
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert not (tmp_path / "step_00000001.npz").exists()
    assert not (tmp_path / "step_00000002.json").exists()
    assert (tmp_path / "step_00000003.npz").exists()
    assert ckpt.keep_last(str(tmp_path), 3) == 0     # idempotent
    with pytest.raises(ValueError, match=">= 1"):
        ckpt.keep_last(str(tmp_path), 0)
    assert ckpt.keep_last(str(tmp_path / "nope"), 2) == 0


def test_restore_missing_manifest_names_latest(tmp_path):
    fleet = save_steps(tmp_path, [3])
    with pytest.raises(FileNotFoundError, match="latest complete step: 3"):
        ckpt.restore(str(tmp_path), 7, fleet, CFG_T)


def test_restore_corrupt_manifest_raises_value_error(tmp_path):
    fleet = save_steps(tmp_path, [1])
    (tmp_path / "step_00000001.json").write_text("{torn")
    with pytest.raises(ValueError, match="corrupt checkpoint manifest"):
        ckpt.restore(str(tmp_path), 1, fleet, CFG_T)
    (tmp_path / "step_00000001.json").write_text('{"step": 1}')
    with pytest.raises(ValueError, match="missing 'arrays'"):
        ckpt.restore(str(tmp_path), 1, fleet, CFG_T)


def test_restore_corrupt_arrays_names_file(tmp_path):
    fleet = save_steps(tmp_path, [1])
    (tmp_path / "step_00000001.npz").write_bytes(b"PK\x03\x04 nope")
    with pytest.raises(ValueError, match="corrupt checkpoint arrays file "
                       ".*step_00000001.npz"):
        ckpt.restore(str(tmp_path), 1, fleet, CFG_T)


def test_restore_missing_arrays_file_raises(tmp_path):
    fleet = save_steps(tmp_path, [1])
    (tmp_path / "step_00000001.npz").unlink()
    with pytest.raises(ValueError, match="missing"):
        ckpt.restore(str(tmp_path), 1, fleet, CFG_T)


def test_restore_refuses_another_layout(tmp_path):
    """A checkpoint of another fleet size, or one lacking a field the
    target asks for, raises and names the leaf."""
    save_steps(tmp_path, [1])
    big = tfleet.fleet_init(CFG_T, A + 1, 0, n_pods=P, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch at 0/.params/"):
        ckpt.restore(str(tmp_path), 1, big, CFG_T)
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(str(tmp_path), 1, fresh(backend="twin"), CFG_T)


# ---------------------------------------------------------------------------
# resume: a split run is the uninterrupted run
# ---------------------------------------------------------------------------
RESUME_CASES = {
    "sign_flip": dict(policy=None, faults=SIGN),
    "noise": dict(policy=None, faults=NOISE),
    "lean-noise": dict(policy="lean", faults=NOISE),
}


def split_run(drive, case, backend="fluid", n_eps=8, cut=3, via=None):
    """The straight run and the run split at ``cut`` (the second part from
    ``via(fleet)``, e.g. a checkpoint, else the same fleet object)."""
    c = RESUME_CASES[case]
    kw = dict(straggler_prob=0.25, seed=7, env_backend=BACKENDS[backend][1],
              transport=ASYNC, faults=c["faults"], guards=ROBUST)
    tr = traces(n_eps)
    straight = drive(CFG_T, fresh(c["policy"], backend), tr, **kw)
    n = CFG_T.n_steps
    f1, h1 = drive(CFG_T, fresh(c["policy"], backend), tr[:, :cut * n],
                   total_episodes=n_eps, **kw)
    if via is not None:
        f1 = via(f1)
    f2, h2 = drive(CFG_T, f1, tr[:, cut * n:], episode_offset=cut,
                   total_episodes=n_eps, **kw)
    assert f2.episode == n_eps
    hist = {k: np.concatenate([h1[k], h2[k]]) for k in h1}
    return straight, (f2, hist)


def assert_same_run(a, b):
    (fa, ha), (fb, hb) = a, b
    for k, v in ha.items():
        np.testing.assert_array_equal(v, hb[k], err_msg=k)
    identical_tree(tfleet.fleet_to_numpy(fa), tfleet.fleet_to_numpy(fb))
    same_generators(fa, fb)


@pytest.mark.parametrize("case", list(RESUME_CASES))
@pytest.mark.parametrize("driver", ["scan", "reference"])
def test_chunked_run_is_the_straight_run(driver, case):
    """TestChunkedResume: [0,3) then [3,8) with the same total gives the
    straight 8-episode run bit for bit, fault plans, straggler draws,
    byzantine noise and the merge cadence included."""
    drive = {"scan": tfleet.train_fleet_scan,
             "reference": tfleet.train_fleet_reference}[driver]
    assert_same_run(*split_run(drive, case))


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_resume_from_a_checkpoint_is_the_straight_run(tmp_path, backend):
    """``test_resume_reproduces_uninterrupted_lean_run``: the first part
    saved, restored into a fresh lean fleet, and continued."""
    def via(fleet):
        ckpt.save(str(tmp_path), 3, fleet)
        return ckpt.restore(str(tmp_path), 3, fresh("lean", backend),
                            CFG_T)[0]
    assert_same_run(*split_run(tfleet.train_fleet_scan, "lean-noise",
                               backend, via=via))


@pytest.mark.parametrize("driver", ["scan", "reference"])
def test_byzantine_noise_continues_across_calls(driver):
    """The repair: the noise generator lives in the fleet, so a run split
    into two driver calls draws the uninterrupted run's noise. Every agent
    is byzantine in every round and there is one pod, so nothing else of
    the run depends on the absolute episode."""
    drive = {"scan": tfleet.train_fleet_scan,
             "reference": tfleet.train_fleet_reference}[driver]
    faults = tfaults.FaultConfig(byzantine_frac=1.0, byzantine_mode="noise",
                                 byzantine_scale=0.5, seed=4)
    kw = dict(transport=ttr.TransportConfig(codec="int8"), faults=faults)
    mk = lambda: tfleet.fleet_init(CFG_T, A, 0, n_pods=1, device="cpu")
    tr, n = traces(4), CFG_T.n_steps
    f_s, h_s = drive(CFG_T, mk(), tr, **kw)
    f_c, h1 = drive(CFG_T, mk(), tr[:, :2 * n], **kw)
    f_c, h2 = drive(CFG_T, f_c, tr[:, 2 * n:], **kw)
    for k, v in h_s.items():
        np.testing.assert_array_equal(v, np.concatenate([h1[k], h2[k]]),
                                      err_msg=k)


def test_offset_past_the_total_raises():
    with pytest.raises(ValueError, match="total_episodes=4 < episode_offset"
                       "=3 \\+ 2 trace episodes"):
        tfleet.train_fleet_scan(CFG_T, fresh(), traces(2), episode_offset=3,
                                total_episodes=4)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
CLI = ["--device", "cpu", "--agents", "4", "--episodes", "6",
       "--fl-every", "1", "--state-dtype", "lean", "--fl-codec", "int8",
       "--fl-deadline-s", "0.002", "--fl-async", "--robust-agg", "trimmed",
       "--fault-crash-prob", "0.2", "--fault-byzantine-frac", "0.3",
       "--fault-byzantine-mode", "noise", "--fault-byzantine-scale", "2",
       "--fault-partition-prob", "0.5", "--straggler-prob", "0.2"]


def saved(d, step):
    with np.load(d / f"step_{step:08d}.npz") as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("backend", ["fluid", "twin"])
def test_cli_stop_after_and_rerun_is_the_straight_run(tmp_path, backend,
                                                      capsys):
    """``--ckpt-every 2 --stop-after 3``, then the same command again: the
    checkpoints land where the JAX CLI's do (2 and 3, then 5 and 6), the
    two invocations' histories are the straight run's, and the final
    checkpoint is the straight run's bit for bit, generators included."""
    extra = ["--env-backend", backend, "--ckpt-every", "2"]
    _, h_s = train_cli.main([*CLI, *extra, "--ckpt-dir",
                             str(tmp_path / "a")])
    capsys.readouterr()
    kill = [*CLI, *extra, "--ckpt-dir", str(tmp_path / "b")]
    _, h1 = train_cli.main([*kill, "--stop-after", "3"])
    out = capsys.readouterr().out
    assert "--stop-after 3: stopping at episode 3/6" in out
    assert sorted(p.name for p in (tmp_path / "b").glob("*.npz")) == \
        ["step_00000002.npz", "step_00000003.npz"]
    _, h2 = train_cli.main(kill)
    out = capsys.readouterr().out
    assert "auto-resume: restored episode 3" in out
    assert "no generator state" not in out
    assert ckpt.latest_step(str(tmp_path / "b")) == 6
    assert {p.name for p in (tmp_path / "b").glob("*.npz")} == \
        {"step_00000003.npz", "step_00000005.npz", "step_00000006.npz"}
    for k, v in h_s.items():
        np.testing.assert_array_equal(v, np.concatenate([h1[k], h2[k]]),
                                      err_msg=k)
    want, got = saved(tmp_path / "a", 6), saved(tmp_path / "b", 6)
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(bits(got[k]), bits(v), err_msg=k)
    _, h3 = train_cli.main(kill)
    assert h3 == {} and "run already complete" in capsys.readouterr().out


def test_cli_resumes_a_jax_checkpoint(tmp_path, capsys):
    """A checkpoint the JAX package wrote resumes in the port's CLI; it
    holds no generator state, so the noise is seeded from the seeds and
    the step, and the CLI says so."""
    jf = jfleet.fleet_init(CFG_J, A, jax.random.PRNGKey(0), n_pods=P,
                           state_policy="lean")
    jckpt.save(str(tmp_path), 2, jf)
    _, hist = train_cli.main([*CLI, "--episodes", "4", "--ckpt-dir",
                              str(tmp_path)])
    out = capsys.readouterr().out
    assert "auto-resume: restored episode 2" in out
    assert "action noise is seeded from --seed 0 and step 2" in out
    assert "byzantine noise is seeded from --fault-seed 0 and step 2" in out
    assert all(v.shape == (2,) and np.isfinite(v).all()
               for v in hist.values())
    jckpt.restore(str(tmp_path), 4, jf)


@pytest.mark.parametrize("argv", [
    ["--ckpt-every", "2"],
    ["--stop-after", "2"],
    ["--ckpt-dir", "DIR", "--driver", "reference"],
    ["--ckpt-dir", "DIR", "--keep-last", "0"],
    ["--ckpt-dir", "DIR", "--ckpt-every", "-1"],
    ["--pallas"],
    ["--fl-pallas"],
    ["--state-dtype", "fp8"],
], ids=["every-no-dir", "stop-no-dir", "reference", "keep-last",
        "negative", "pallas-fluid", "fl-pallas-f32", "bad-policy"])
def test_cli_flag_errors_match_jax(argv, tmp_path, capsys):
    from repro.launch import train_fleet as jax_cli
    argv = [str(tmp_path) if a == "DIR" else a for a in argv]
    errors = []
    for cli in (jax_cli, train_cli):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--episodes", "1", *argv])
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0].split("error: ")[1] == errors[1].split("error: ")[1]
    assert not any(tmp_path.iterdir())


def test_cli_pallas_flags_change_nothing(capsys):
    """``--pallas`` (twin) and ``--fl-pallas`` (compressed codec) are
    accepted; the device picks the kernel path, so the run is the same."""
    base = ["--device", "cpu", "--agents", "4", "--episodes", "2",
            "--fl-every", "1", "--env-backend", "twin", "--fl-codec",
            "int8"]
    _, h0 = train_cli.main(base)
    _, h1 = train_cli.main([*base, "--pallas", "--fl-pallas"])
    for k, v in h0.items():
        np.testing.assert_array_equal(v, h1[k], err_msg=k)
    assert "device picks" in train_cli.__doc__
