"""The fleet mesh of the port: the spec rules against the JAX package's,
and meshed runs on gloo ranks against the meshless run.

The spec rules (``repro_torch.distributed.sharding``) are pure functions of
shapes and axis sizes: each is held against ``repro.distributed.sharding``
on shape-only meshes ((pod 2, data 4), (data 4), (data 4, model 2),
(16, 16), (2, 16, 16)), the cache rules against JAX's on an
``AbstractMesh``.

The meshed runs hold ``tests/test_mesh.py``'s contract on the port. Eight
gloo ranks (``tests/torch_mesh_rank.py``, spawned, one thread each, a
``file://`` rendezvous) run the CLI under ``--mesh fleet`` as (pod 2,
data 4) with 16 agents; the meshless CLI runs here. A meshed run equals
the meshless one within rtol/atol 1e-5 (the ranks' partial sums add in
another order), integer state and decisions exact; the state is split
(eight balanced ``fleet_device_bytes`` entries); the stream equals the
history; lean + int8 trains finite with bf16 Adam moments; a replicated
fleet (A=3), the robust statistics, the chaos layer with health, the
byzantine noise, the reference driver, the twin and the debug mesh equal
their meshless runs; checkpoints pass between meshed and meshless runs;
the graph driver warms each process group, the pod group (two ranks)
included, before any capture. One rank under ``--mesh fleet`` equals ``--mesh none`` bit for bit. A
library run from a JAX fleet with JAX's noise links the chain: meshed ==
the port's meshless run == JAX's ``train_fleet_scan``. Every spawn has a
progress limit: the ranks mark each scenario they finish, and when none
has finished one for ``STALL_S`` (or the spawn passes ``SPAWN_CAP_S``) they
are killed and the test fails, naming the scenario each rank had reached.
A rank stuck in a collective raises after ``COLLECTIVE_TIMEOUT_S``. A
fixed wall limit would fail a world that is only slow because the host is
busy beside it (on an 8-core host the spawn took 78–159 s beside six busy
processes).
"""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.fcpo import FCPOConfig as JCfg
from repro.core import fleet as jfleet
from repro.distributed import sharding as jshd
from repro.launch import simulate as jsim_cli
from repro.models.registry import get_config, get_model
from repro_torch.configs.fcpo import FCPOConfig as TCfg
from repro_torch.core import fleet as tfleet
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import simulate as tsim_cli
from repro_torch.launch import train_fleet as train_cli
from repro_torch.training import checkpoint as ckpt
from test_torch_support import (close, close_state, close_tree, exact,
                                head_sizes, jax_episode_noise,
                                jax_fleet_tree)

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mesh_rank.py"
# no rank finished a scenario for STALL_S: the world is stuck; a spawn
# that goes on making progress is still cut at SPAWN_CAP_S; a rank waits
# at most COLLECTIVE_TIMEOUT_S in one collective before it raises
STALL_S = 180
SPAWN_CAP_S = 480
COLLECTIVE_TIMEOUT_S = 120
POLL_S = 0.5


# ---------------------------------------------------------------------------
# Spec rules
# ---------------------------------------------------------------------------
class _SpecMesh:
    """Shape-only stand-in for a mesh: both packages' rules read only
    ``mesh.shape``."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)


MESHES = {
    "pod2_data4": _SpecMesh(pod=2, data=4),
    "data4": _SpecMesh(data=4),
    "data4_model2": _SpecMesh(data=4, model=2),
    "prod": _SpecMesh(data=16, model=16),
    "prod_multipod": _SpecMesh(pod=2, data=16, model=16),
}


def same(port, jax_spec, msg=""):
    assert port == tuple(jax_spec), f"{msg}: {port} != {tuple(jax_spec)}"


@pytest.mark.parametrize("shape,prefs,priority", [
    ((128, 4096), [["data"], ["model"]], None),
    ((40, 1536, 512), [["model"], ["data"], ["model"]], None),
    ((64, 64), [["model"], ["model"]], None),
    ((256, 4096), [[("pod", "data"), "data"], []], None),
    ((16, 4096), [[("pod", "data"), "data"], []], None),
    ((8, 32768, 16, 128), [[], ["model"], ["model"], []], [0, 2, 1, 3]),
    ((6, 8), [[None, "data"], ["data"]], None),
    ((3,), [["pod", "data"]], None),
], ids=["divisible", "fall-through", "axis-once", "composite",
        "composite-fallback", "priority", "none-stops", "indivisible"])
def test_greedy_spec_matches_jax(shape, prefs, priority):
    for name, mesh in MESHES.items():
        same(tshd.greedy_spec(shape, prefs, mesh, priority),
             jshd.greedy_spec(shape, prefs, mesh, priority), name)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_fleet_specs_match_jax(mesh_name):
    """``agent_spec`` / ``pod_spec`` / ``agent_batch_spec`` at A in {3, 4,
    8, 16} and P in {2, 3, 4}, on every mesh."""
    mesh = MESHES[mesh_name]
    for a in (3, 4, 8, 16):
        same(tshd.agent_spec((a, 31), mesh), jshd.agent_spec((a, 31), mesh),
             f"agent A={a}")
        same(tshd.agent_spec((a,), mesh), jshd.agent_spec((a,), mesh))
        for shape, axis in (((5, a, 10), 1), ((a, 7), 0), ((5, a), 3)):
            same(tshd.agent_batch_spec(shape, mesh, axis),
                 jshd.agent_batch_spec(shape, mesh, axis),
                 f"batch {shape} axis {axis}")
    for p in (2, 3, 4):
        same(tshd.pod_spec((p, 31), mesh), jshd.pod_spec((p, 31), mesh),
             f"pod P={p}")
    same(tshd.agent_spec((), mesh), jshd.agent_spec((), mesh))
    same(tshd.pod_spec((), mesh), jshd.pod_spec((), mesh))


def test_fleet_specs_of_the_jax_contract():
    """``tests/test_mesh.py``'s spec cases, on the port."""
    mesh = MESHES["pod2_data4"]
    assert tshd.agent_spec((8, 31), mesh) == (("pod", "data"),)
    assert tshd.agent_spec((4, 31), mesh) == ("data",)
    assert tshd.agent_spec((3, 31), mesh) == ()
    assert tshd.pod_spec((2, 31), mesh) == ("pod",)
    assert tshd.pod_spec((4, 31), mesh) == ("pod",)
    assert tshd.pod_spec((3, 31), mesh) == ()
    assert tshd.pod_spec((4, 31), MESHES["data4"]) == ("data",)
    assert tshd.pod_spec((2, 31), MESHES["data4"]) == ()


@pytest.fixture(scope="module")
def jax_fleet():
    """The JAX fleet of the meshed runs (A=16, P=2; ``fleet_init`` takes
    seconds in JAX: made once)."""
    return jfleet.fleet_init(JCfg(fl_every=1), A, jax.random.PRNGKey(0),
                             n_pods=P)


def test_fleet_shardings_match_jax(jax_fleet):
    """The port's ``fleet_shardings`` against JAX's ``fleet_shardings`` (on
    an ``AbstractMesh``) leaf for leaf, A=16 on (pod 2, data 4) and (data
    4, model 2)."""
    spec_of = lambda x: tuple(x.spec)
    for mesh_name in ("pod2_data4", "data4_model2"):
        sizes = MESHES[mesh_name].shape
        amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
        a, jf = A, jax_fleet
        js = jfleet.fleet_shardings(jf, amesh)
        tf = tfleet.fleet_init(TCfg(), a, 0, n_pods=P, device="cpu")
        got = tfleet.fleet_shardings(tf, MESHES[mesh_name])

        def match(jtree, ptree, name):
            flat = {}
            jax.tree_util.tree_map_with_path(
                lambda p, x: flat.setdefault(jshd._path_str(p), spec_of(x)),
                jtree)
            for path, want in flat.items():
                node = ptree
                for k in path.split("/") if path else ():
                    node = node[k]
                assert node == want, f"A={a} {name}/{path}: {node} != {want}"
            return len(flat)
        n = 0
        n += match(js.astate.params, got["params"], "params")
        n += match(js.astate.opt["m"], got["opt"]["m"], "opt.m")
        n += match(js.astate.buffer._asdict(), got["buffer"], "buffer")
        n += match(js.astate.env_state._asdict(), got["env_state"], "env")
        n += match(js.base_params, got["base_params"], "base_params")
        n += match(js.residuals, got["residuals"], "residuals")
        for field in ("masks", "env_params"):
            n += match(getattr(js, field)._asdict(), got[field], field)
        for field in ("speeds", "bandwidth", "crash_timer",
                      "partition_timer", "episode"):
            assert got[field] == spec_of(getattr(js, field)), field
        assert n > 30


def _qwen_leaves():
    cfg = get_config("qwen2-0.5b")
    tree = jax.eval_shape(get_model(cfg).init, jax.random.PRNGKey(0))
    out = []
    jax.tree_util.tree_map_with_path(
        lambda p, x: out.append((jshd._path_str(p), x.shape)), tree)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_spec_matches_jax_on_qwen2(mesh_name):
    """Every leaf path of the qwen2-0.5b parameter tree, with and without
    FSDP."""
    mesh = MESHES[mesh_name]
    leaves = _qwen_leaves()
    assert len(leaves) > 10
    for path, shape in leaves:
        for fsdp in (True, False):
            same(tshd.param_spec(path, shape, mesh, fsdp),
                 jshd.param_spec(path, shape, mesh, fsdp),
                 f"{path} fsdp={fsdp}")


# one synthetic (path, shape) per rule of _PARAM_RULES, then the generic
# fallbacks (large -> model/data, small -> replicated)
RULE_CASES = [
    ("embed/table", (152064, 896)), ("lm_head/w", (896, 151936)),
    ("patch_proj/w", (1024, 5120)), ("blocks/attn/wq/w", (24, 896, 896)),
    ("blocks/attn/wk/b", (24, 128)), ("blocks/attn/wo/w", (24, 896, 896)),
    ("blocks/attn/wkv_a/w", (27, 2048, 576)),
    ("blocks/attn/wkv_b/w", (27, 512, 4096)),
    ("blocks/mlp/gate/w", (24, 896, 4864)),
    ("blocks/mlp/down/w", (24, 4864, 896)),
    ("blocks/moe/router/w", (24, 1536, 40)),
    ("blocks/moe/up", (24, 40, 1536, 512)),
    ("blocks/moe/down", (24, 64, 512, 1536)),
    ("blocks/moe/shared/gate/w", (24, 1536, 1024)),
    ("blocks/moe/shared/down/w", (24, 1024, 1536)),
    ("mamba/in_proj/w", (38, 2048, 8192)),
    ("mamba/out_proj/w", (38, 4096, 2048)), ("mamba/conv_w", (38, 4, 4096)),
    ("mamba/conv_b", (38, 4096)), ("blocks/cell/wq/w", (12, 768, 768)),
    ("blocks/cell/out_proj/w", (12, 768, 768)),
    ("blocks/cell/w_in/w", (12, 768, 3072)),
    ("blocks/ln1/scale", (24, 896)), ("final_norm/scale", (896,)),
    ("frontend/proj", (4096, 1024)), ("frontend/small", (8, 8)),
]


def test_every_param_rule_has_a_case():
    import re
    for pat, _ in tshd._PARAM_RULES:
        assert any(re.search(pat, p) for p, _ in RULE_CASES), pat
    assert tshd._PARAM_RULES == jshd._PARAM_RULES
    assert tshd._STACKED_PREFIXES == jshd._STACKED_PREFIXES


@pytest.mark.parametrize("path,shape", RULE_CASES,
                         ids=[p for p, _ in RULE_CASES])
def test_param_spec_rules_match_jax(path, shape):
    for name, mesh in MESHES.items():
        for fsdp in (True, False):
            same(tshd.param_spec(path, shape, mesh, fsdp),
                 jshd.param_spec(path, shape, mesh, fsdp),
                 f"{name} fsdp={fsdp}")


def test_batch_logits_and_strip_match_jax():
    for name, mesh in MESHES.items():
        for shape, seq in (((256, 4096), None), ((16, 4096), None),
                           ((1, 32768), 1), ((4, 2048, 896), 1),
                           ((3, 7), None)):
            same(tshd.batch_spec(shape, mesh, seq),
                 jshd.batch_spec(shape, mesh, seq), f"{name} {shape}")
        same(tshd.logits_spec(mesh),
             jshd.logits_shardings(AbstractMesh(
                 tuple(mesh.shape.values()),
                 tuple(mesh.shape))).spec, name)
    for spec, axis in (((("pod", "data"), "model"), "data"),
                       (("data", None, "model"), "data"),
                       ((None, "data"), "data"),
                       ((("pod", "data", "model"),), "pod")):
        same(tshd.strip_axis(spec, axis),
             jshd.strip_axis(jax.sharding.PartitionSpec(*spec), axis),
             f"{spec} - {axis}")


CACHE_TREE = {
    "layers": {"k": (24, 8, 4096, 2, 64), "v": (24, 8, 4096, 2, 64),
               "kv_latent": (27, 8, 4096, 512)},
    "mamba": {"C": (38, 8, 64, 64, 128), "h": (38, 8, 64, 64),
              "conv": (38, 8, 4, 4096)},
    "attn": {"k": (6, 16, 2048, 32, 128)},
    "offset": (),
    "flat": (8, 896),
}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_cache_specs_match_jax(mesh_name):
    """``cache_shardings`` on a jax 0.9.0 ``AbstractMesh(sizes, names)``
    against the port's ``cache_specs``, stacked and not."""
    sizes = MESHES[mesh_name].shape
    amesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    sds = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                       CACHE_TREE, is_leaf=lambda x: isinstance(x, tuple))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v
    walk(CACHE_TREE, "")
    for stacked in (True, False):
        want = {}
        jax.tree_util.tree_map_with_path(
            lambda p, s: want.setdefault(jshd._path_str(p), s.spec),
            jshd.cache_shardings(sds, amesh, stacked=stacked))
        got = tshd.cache_specs(flat, MESHES[mesh_name], stacked)
        assert set(got) == set(want)
        for path in flat:
            same(got[path], want[path], f"{path} stacked={stacked}")


# ---------------------------------------------------------------------------
# Meshed runs over gloo
# ---------------------------------------------------------------------------
N_RANKS, A, P = 8, 16, 2
BASE = ["--device", "cpu", "--pods", str(P), "--fl-every", "1", "--seed", "0"]
# the chaos scenarios aggregate by the robust statistics: under byzantine
# uploads (x10) the mean amplifies the reordering of the ranks' partial sums
# beyond the band (ROADMAP queue 3), while the robust statistics rank the
# gathered rows as the meshless run does
INT8_CHAOS = ["--fl-codec", "int8", "--fl-deadline-s", "0.002", "--fl-async",
              "--robust-agg", "trimmed",
              "--clip-factor", "3", "--fault-crash-prob", "0.1",
              "--fault-byzantine-frac", "0.25", "--fault-partition-prob",
              "0.3", "--health", "--susp-threshold", "0.5"]
# name -> (the CLI arguments but --mesh, the mesh, the int8 codec's tie rule)
SCENARIOS = {
    "main": (["--agents", str(A), "--episodes", "8", "--straggler-prob",
              "0.3"], "fleet", False),
    "lean": (["--agents", str(A), "--episodes", "6", "--state-dtype", "lean",
              "--fl-codec", "int8"], "fleet", True),
    "trimmed": (["--agents", str(A), "--episodes", "6", "--robust-agg",
                 "trimmed", "--straggler-prob", "0.3"], "fleet", False),
    "median": (["--agents", str(A), "--episodes", "6", "--robust-agg",
                "median", "--straggler-prob", "0.3"], "fleet", False),
    "replicated": (["--agents", "3", "--episodes", "6", "--straggler-prob",
                    "0.3"], "fleet", False),
    "chaos_health": (["--agents", str(A), "--episodes", "6"] + INT8_CHAOS,
                     "fleet", True),
    "byz_noise": (["--agents", str(A), "--episodes", "3",
                   "--fault-byzantine-frac", "0.25", "--fault-byzantine-mode",
                   "noise", "--robust-agg", "median"], "fleet", False),
    "reference": (["--agents", str(A), "--episodes", "4", "--driver",
                   "reference", "--straggler-prob", "0.3"], "fleet", False),
    "twin": (["--agents", str(A), "--episodes", "3", "--env-backend",
              "twin"], "fleet", False),
    "debug": (["--agents", str(A), "--episodes", "4"], "debug", False),
}
LIB = dict(n_eps=8, straggler_prob=0.3, seed=7)


def _meshless(argv, out):
    """The meshless CLI run of ``argv`` here, saved like a rank's."""
    fleet, hist = train_cli.main(argv)
    ckpt.save(str(out), 0, fleet)
    return hist


def _flat_fleet(path, step=0):
    """A saved fleet as {key: array}, bf16 leaves widened to float32."""
    manifest, data = ckpt.load(str(path), step)
    bf16 = {k for k, d in manifest["dtypes"].items() if d == "bfloat16"}
    wide = lambda a: (a.view(np.uint16).astype(np.uint32) << 16).view(
        np.float32)
    return {k: wide(data[k]) if k in bf16 else data[k]
            for k in data.files}, manifest


def _close_leaf(got, want, key, manifest, tol):
    """One saved leaf: floats within ``tol`` (bf16 leaves within two bf16
    steps, 2^-7 relative: a float32 ulp upstream can round a bf16 value
    the other way), integers and booleans exact."""
    if manifest["dtypes"].get(key) == "bfloat16":
        close(got, want, key, rtol=2.0 ** -7, atol=1e-5)
    elif want.dtype.kind == "f":
        close(got, want, key, **tol)
    else:
        exact(got, want, key)


def _markers(log):
    """The ``MESH-PROGRESS`` markers of a rank's log, as (what, name)."""
    if not log.exists():
        return []
    return [tuple(line.split()[1:3]) for line in
            log.read_text(errors="replace").splitlines()
            if line.startswith("MESH-PROGRESS ")]


def _reached(markers):
    """Where a rank is, from its markers."""
    if not markers:
        return "not started"
    what, name = markers[-1]
    return f"in {name}" if what == "start" else f"done {name}"


def spawn(world, spec, tmp):
    """``world`` ranks of ``torch_mesh_rank.py`` on ``spec``; fails (the
    ranks killed) on a rank's error, when no rank has finished a scenario
    for ``STALL_S``, or at ``SPAWN_CAP_S``. Returns the spawn's seconds."""
    spec = dict(spec, collective_timeout_s=COLLECTIVE_TIMEOUT_S)
    spec_path = tmp / f"spec{world}.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1")
    paths = [tmp / f"rank{world}_{r}.log" for r in range(world)]
    logs = [open(path, "w") for path in paths]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world),
         str(tmp / f"rendezvous{world}"), str(spec_path)],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    start = last = time.monotonic()
    done, why = 0, None
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(
                    c not in (None, 0) for c in codes):
                break                       # all ended, or one failed
            now = time.monotonic()
            n = sum(what == "done" for path in paths
                    for what, _ in _markers(path))
            if n > done:
                done, last = n, now
            if now - last > STALL_S:
                why = f"no rank finished a scenario for {STALL_S} s"
                break
            if now - start > SPAWN_CAP_S:
                why = f"the spawn passed its cap of {SPAWN_CAP_S} s"
                break
            time.sleep(POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    seconds = time.monotonic() - start
    codes = [p.returncode for p in procs]
    print(f"spawn of {world} rank(s): {seconds:.1f} s")
    if why or any(c != 0 for c in codes):
        where = ", ".join(f"rank {r}: {_reached(_markers(path))}"
                          for r, path in enumerate(paths))
        tails = "\n".join(
            f"--- rank {r} (exit {c}) ---\n"
            + paths[r].read_text(errors="replace")[-3000:]
            for r, c in enumerate(codes) if c != 0)
        pytest.fail(f"meshed ranks failed after {seconds:.1f} s"
                    f"{': ' + why if why else ''}: exits {codes}\n"
                    f"{where}\n{tails}")
    return seconds


def test_progress_markers_say_where_each_rank_is(tmp_path):
    """What ``spawn`` reads from a rank's log to measure progress and to
    name, on a failure, the scenario each rank had reached."""
    log = tmp_path / "rank.log"
    assert _markers(log) == [] and _reached([]) == "not started"
    log.write_text("MESH-PROGRESS start mesh_factory\nsome output\n"
                   "MESH-PROGRESS done mesh_factory\n"
                   "MESH-PROGRESS start main\nstep 1 ...\n")
    marks = _markers(log)
    assert marks == [("start", "mesh_factory"), ("done", "mesh_factory"),
                     ("start", "main")]
    assert _reached(marks) == "in main"
    assert _reached(marks[:2]) == "done mesh_factory"
    assert STALL_S > COLLECTIVE_TIMEOUT_S and SPAWN_CAP_S > STALL_S


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_fleet):
    """The meshless runs here, then one spawn of eight gloo ranks running
    every scenario meshed, and one spawn of a single rank. Returns the
    directories of both."""
    tmp = tmp_path_factory.mktemp("mesh")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mine, ranks = tmp / "meshless", tmp / "meshed"
        for d in (mine, ranks, tmp / "one"):
            d.mkdir()
        for name, (args, _, _) in SCENARIOS.items():
            extra = []
            if name == "main":
                extra = ["--metrics-out", str(mine / "main.jsonl"),
                         "--ckpt-dir", str(mine / "main_ckpt"),
                         "--ckpt-every", "4"]
            hist = _meshless(BASE + args + ["--mesh", "none"] + extra,
                             mine / name)
            np.savez(mine / name / "hist.npz", **hist)
        # the meshless step-4 checkpoint, for the meshed resume
        resume = ranks / "resume_ckpt"
        resume.mkdir()
        for f in ("step_00000004.npz", "step_00000004.json"):
            shutil.copy(mine / "main_ckpt" / f, resume / f)
        lib_npz = _lib_inputs(tmp, jax_fleet)
        scenarios = [{"name": name, "argv": BASE + args + ["--mesh", mesh]
                      + (["--metrics-out", str(ranks / "main.jsonl"),
                          "--ckpt-dir", str(ranks / "main_ckpt"),
                          "--ckpt-every", "4"] if name == "main" else [])}
                     for name, (args, mesh, _) in SCENARIOS.items()]
        scenarios.append({"name": "resume", "argv": BASE + SCENARIOS[
            "main"][0] + ["--mesh", "fleet", "--ckpt-dir", str(resume)]})
        scenarios.append({"name": "lib", "lib": dict(
            npz=str(lib_npz), straggler_prob=LIB["straggler_prob"],
            seed=LIB["seed"])})
        spawn(N_RANKS, {"out": str(ranks), "scenarios": scenarios,
                        "mesh_factory": True}, tmp)
        spawn(1, {"out": str(tmp / "one"), "scenarios": [
            {"name": "main", "argv": BASE + SCENARIOS["main"][0]
             + ["--mesh", "fleet"]}]}, tmp)
    finally:
        torch.set_num_threads(threads)
    return {"meshless": mine, "meshed": ranks, "one": tmp / "one",
            "lib_npz": lib_npz}


def _lib_inputs(tmp, jf):
    """The JAX fleet ``jf`` (A=16, P=2), traces, and JAX's action noise
    for ``LIB["n_eps"]`` episodes, as the ranks' ``lib`` scenario reads
    them."""
    cfg = JCfg(fl_every=1)
    traces = np.random.default_rng(0).uniform(
        5.0, 160.0, (A, LIB["n_eps"] * cfg.n_steps)).astype(np.float32)
    rngs, noise = jf.astate.rng, []
    for _ in range(LIB["n_eps"]):
        g, rngs = jax_episode_noise(rngs, cfg.n_steps, head_sizes(cfg))
        noise.append(np.asarray(g))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"fleet/{prefix}{k}"] = np.asarray(v)
    walk(jax_fleet_tree(jf), "")
    path = tmp / "lib.npz"
    np.savez(path, traces=traces, gumbel=np.stack(noise), **flat)
    return path


def _hist(path):
    with np.load(path / "hist.npz") as h:
        return {k: h[k] for k in h.files}


def _info(path):
    return json.loads((path / "info.json").read_text())


def _equal_runs(runs, name, int8_ties=False, exact_floats=False):
    """The meshed run ``name`` against its meshless run: histories and the
    whole fleet within rtol/atol 1e-5 (bit for bit with ``exact_floats``),
    integer and boolean leaves exact; int8 residuals by the tie rule of
    ``close_state``."""
    tol = dict(rtol=0.0, atol=0.0) if exact_floats else \
        dict(rtol=1e-5, atol=1e-5)
    got_h = _hist(runs["meshed"] / name)
    want_h = _hist(runs["meshless"] / name)
    assert set(got_h) == set(want_h)
    for k, v in want_h.items():
        close(got_h[k], v, f"history {k}", **tol)
    got, _ = _flat_fleet(runs["meshed"] / name)
    want, manifest = _flat_fleet(runs["meshless"] / name)
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith("9/") and int8_ties:
            close_state({"residuals": {k: got[k]}},
                        {"residuals": {k: v}}, ("residuals",), "int8")
        else:
            _close_leaf(got[k], v, k, manifest, tol)


def test_mesh_factory_shapes_and_errors(runs):
    info = json.loads((runs["meshed"] / "mesh_factory.json").read_text())
    assert info["fleet_2"] == [2, 4]
    assert info["fleet_3"] == [1, 8]          # 3 does not divide 8
    assert info["debug"] == [8, 1]
    assert "256 ranks; the world has 8" in info["production"]
    assert "16 ranks; the world has 8" in info["wrong_size"]
    # rank 0 of a (pod 2, data 2, model 2) mesh with A=4 agents over
    # (pod, data): agent 0, its group the ranks of model coordinate 0
    pdm = info["pod_data_model"]
    assert pdm["agents"] == [0, 1]
    assert pdm["group"] == [0, 2, 4, 6]
    assert pdm["rank_sum"] == 12.0 and pdm["start_sum"] == 0 + 1 + 2 + 3


def test_meshed_run_equals_meshless(runs):
    """(pod 2, data 4), A=16, 8 episodes, stragglers 0.3: within 1e-5,
    selections and integer state exact."""
    _equal_runs(runs, "main")
    # the selection counts are integers: equal, not close
    got, want = _hist(runs["meshed"] / "main"), \
        _hist(runs["meshless"] / "main")
    for k in ("fl_payload_bytes", "fl_missed"):
        exact(got[k], want[k], k)


def test_meshed_state_is_split(runs):
    """Eight ranks, two agents each: eight balanced ``fleet_device_bytes``
    entries, the agents split over (pod, data)."""
    info = _info(runs["meshed"] / "main")
    per = info["device_bytes"]
    assert len(per) == N_RANKS
    vals = sorted(per.values())
    assert vals[-1] <= 2.0 * vals[0]
    assert info["agents"] == [0, A // N_RANKS] and info["agents_split"]
    # a rank's slice is an eighth of the agents' bytes, plus its pod's base
    whole = tfleet.fleet_device_bytes(tfleet.fleet_init(
        TCfg(fl_every=1), A, 0, n_pods=P, device="cpu"))[0]
    assert sum(vals) < 1.5 * whole


def test_graph_driver_warms_each_group_before_capture(runs):
    """The graph driver over (pod 2, data 4), where the pod group is a
    group of two ranks and not the world: before any capture it issues one
    collective on the world (the agent group too) and one on the pod
    group, so no communicator is first created inside a capture."""
    info = _info(runs["meshed"] / "lib")
    assert not info["pod_group_is_world"]
    assert info["warmed"] == [N_RANKS, P]
    assert info["graph_launches"] == 0       # the CPU runs the bodies eagerly


def test_meshed_stream_equals_history(runs):
    """Rank 0's stream: every episode once, in order, equal to the
    history; the scaling row counts eight devices."""
    from repro_torch.eval.stream import read_metrics
    meta, records = read_metrics(str(runs["meshed"] / "main.jsonl"))
    hist = _hist(runs["meshed"] / "main")
    episodes = [r for r in records if "episode" in r]
    assert [r["episode"] for r in episodes] == list(range(8))
    for e, rec in enumerate(episodes):
        for k, v in rec.items():
            if k != "episode":
                assert v == float(hist[k][e]), f"{k}@{e}"
    scaling = [r for r in records if "devices" in r]
    assert len(scaling) == 1 and scaling[0]["devices"] == N_RANKS
    assert sum(k.startswith("dev") and k.endswith("_bytes")
               for k in scaling[0]) == N_RANKS
    assert meta["agents"] == A


def test_meshed_lean_int8_trains_finite(runs):
    """lean + int8 on the mesh: finite, bf16 Adam moments, and the
    meshless run's numbers (int8 ties by their rule)."""
    hist = _hist(runs["meshed"] / "lean")
    assert np.isfinite(hist["reward"]).all()
    _, manifest = _flat_fleet(runs["meshed"] / "lean")
    assert manifest["dtypes"]["0/.opt/m/head_bs/w"] == "bfloat16"
    _equal_runs(runs, "lean", int8_ties=True)


def test_replicated_agents_keep_local_sums(runs):
    """A=3 divides no axis of (2, 4): every rank holds every agent, the
    sums stay local, and the run is the meshless one bit for bit."""
    info = _info(runs["meshed"] / "replicated")
    assert info["agents"] == [0, 3] and not info["agents_split"]
    _equal_runs(runs, "replicated", exact_floats=True)


@pytest.mark.parametrize("name", ["trimmed", "median"])
def test_robust_aggregation_on_the_mesh(runs, name):
    _equal_runs(runs, name)


@pytest.mark.parametrize("name,ties", [
    ("chaos_health", True), ("byz_noise", False), ("reference", False),
    ("twin", False), ("debug", False)])
def test_meshed_paths_equal_meshless(runs, name, ties):
    """The chaos layer with health and the suspicion gate (int8, async,
    clip, crashes, byzantine, partitions), the byzantine noise drawn for
    the whole fleet, the reference driver, the twin (its state exact) and
    the (8, 1) debug mesh."""
    _equal_runs(runs, name, int8_ties=ties)


def test_meshed_save_restores_meshless(runs, tmp_path):
    """The meshed run's episode-4 checkpoint resumed meshless equals the
    straight meshless run."""
    d = tmp_path / "ck"
    d.mkdir()
    for f in ("step_00000004.npz", "step_00000004.json"):
        shutil.copy(runs["meshed"] / "main_ckpt" / f, d / f)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_cli.main(BASE + SCENARIOS["main"][0]
                       + ["--mesh", "none", "--ckpt-dir", str(d)])
    finally:
        torch.set_num_threads(threads)
    got = _flat_fleet(d, 8)[0]
    want = _flat_fleet(runs["meshless"] / "main_ckpt", 8)[0]
    for k, v in want.items():
        if v.dtype.kind == "f":
            close(got[k], v, k, rtol=1e-5, atol=1e-5)
        else:
            exact(got[k], v, k)


def test_meshless_save_restores_meshed(runs):
    """The meshless episode-4 checkpoint resumed on the mesh equals the
    straight meshless run."""
    got = _flat_fleet(runs["meshed"] / "resume_ckpt", 8)[0]
    want = _flat_fleet(runs["meshless"] / "main_ckpt", 8)[0]
    for k, v in want.items():
        if v.dtype.kind == "f":
            close(got[k], v, k, rtol=1e-5, atol=1e-5)
        else:
            exact(got[k], v, k)


def test_one_rank_mesh_is_meshless_bit_for_bit(runs):
    """One rank under ``--mesh fleet``: every collective runs, over a
    world of one, and the run is ``--mesh none``'s bit for bit."""
    info = _info(runs["one"] / "main")
    assert info["collectives"] > 0 and info["agents_split"]
    got, want = _hist(runs["one"] / "main"), _hist(runs["meshless"] / "main")
    for k, v in want.items():
        exact(got[k], v, k)
    g, _ = _flat_fleet(runs["one"] / "main")
    w, _ = _flat_fleet(runs["meshless"] / "main")
    for k, v in w.items():
        exact(g[k], v, k)


def test_meshed_library_run_links_to_jax(runs, jax_fleet):
    """A JAX fleet and JAX's action noise: the port's meshless
    ``train_fleet_scan`` equals JAX's within the repo's band, and the
    meshed run (the whole inputs sliced per rank) equals the meshless one
    within 1e-5."""
    data = np.load(runs["lib_npz"])
    cfg_j, cfg_t = JCfg(fl_every=1), TCfg(fl_every=1)
    jf0 = jax_fleet
    kw = dict(straggler_prob=LIB["straggler_prob"], seed=LIB["seed"])
    jf, hist_j = jfleet.train_fleet_scan(cfg_j, jf0,
                                         jnp.asarray(data["traces"]), **kw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tf, hist_t = tfleet.train_fleet_scan(
            cfg_t, tfleet.fleet_from_numpy(cfg_t, jax_fleet_tree(jf0),
                                           device="cpu"),
            torch.tensor(data["traces"]), gumbel=torch.tensor(data["gumbel"]),
            **kw)
    finally:
        torch.set_num_threads(threads)
    for k, v in hist_t.items():
        close(v, hist_j[k], k)
    close_state(tfleet.fleet_to_numpy(tf), jax_fleet_tree(jf),
                ("params", "opt", "base_params", "buffer", "env_state"),
                "float32")
    got_h = _hist(runs["meshed"] / "lib")
    for k, v in hist_t.items():
        close(got_h[k], v, k, rtol=1e-5, atol=1e-5)
    got, _ = _flat_fleet(runs["meshed"] / "lib")
    mine = ckpt.fleet_flat(tf)
    for k, v in mine.items():
        if k.startswith("torch/"):
            continue
        if v.dtype.kind == "f":
            close(got[k], v, k, rtol=1e-5, atol=1e-5)
        else:
            exact(got[k], v, k)


# ---------------------------------------------------------------------------
# simulate --pallas
# ---------------------------------------------------------------------------
def test_simulate_takes_and_refuses_pallas_as_jax(capsys, monkeypatch):
    """Both CLIs accept ``--pallas`` and refuse it beside
    ``--attribution`` (or ``--trace-out``, which implies it) with the same
    message. JAX's acceptance is read where its CLI asks for the fused
    backend (its run is not needed); the port's run with the flag prints
    what the run without it prints."""
    argv = ["--agents", "2", "--intervals", "3", "--scenario", "steady"]
    for bad in (["--pallas", "--attribution"],
                ["--pallas", "--trace-out", "x.json"]):
        msgs = []
        for main, extra in ((jsim_cli.main, []),
                            (tsim_cli.main, ["--device", "cpu"])):
            with pytest.raises(SystemExit) as e:
                main(argv + bad + extra)
            assert e.value.code == 2
            msgs.append(capsys.readouterr().err.strip().splitlines()[-1])
        assert msgs[0].split("error: ")[1] == msgs[1].split("error: ")[1]
        assert "drop --pallas" in msgs[0]

    class Accepted(Exception):
        pass

    def backend(name, **kw):
        raise Accepted(kw["use_pallas"])
    monkeypatch.setattr(jsim_cli, "get_backend", backend)
    with pytest.raises(Accepted) as e:
        jsim_cli.main(argv + ["--pallas"])
    assert e.value.args == (True,)
    outs = []
    for extra in ([], ["--pallas"]):
        tsim_cli.main(argv + ["--device", "cpu"] + extra)
        outs.append([ln for ln in capsys.readouterr().out.splitlines()
                     if not ln.startswith("wall")])
    assert outs[0] == outs[1]
