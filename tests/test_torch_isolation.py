"""The port stands alone: ``repro_torch`` imports neither JAX nor anything of
the JAX package ``repro``; its kernels build from the repo's sources with
nvcc for sm_90a, and a missing toolchain raises instead of falling back."""
import importlib
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'ml_dtypes')) or k == 'repro' or "
        "k.startswith('repro.'))\n"
        "assert len(mods) >= 76, mods\n"
        "assert {'repro_torch.core.dtypes', 'repro_torch.training', "
        "'repro_torch.training.checkpoint', 'repro_torch.eval', "
        "'repro_torch.eval.stream', 'repro_torch.eval.leaderboard', "
        "'repro_torch.launch.watch', 'repro_torch.health', "
        "'repro_torch.health.sketch', 'repro_torch.health.drift', "
        "'repro_torch.health.attribution', 'repro_torch.health.alerts', "
        "'repro_torch.obs', 'repro_torch.obs.trace', "
        "'repro_torch.obs.requests', 'repro_torch.obs.profile', "
        "'repro_torch.kernels.span_stamp', 'repro_torch.core.baselines', "
        "'repro_torch.sim.oracle', 'repro_torch.distributed', "
        "'repro_torch.distributed.sharding', 'repro_torch.launch.mesh', "
        "'repro_torch.models.moe', 'repro_torch.models.attention', "
        "'repro_torch.models.ssm', 'repro_torch.models.hybrid', "
        "'repro_torch.data.pipeline', 'repro_torch.training.optimizer', "
        "'repro_torch.training.train_step', "
        "'repro_torch.training.compression', 'repro_torch.launch.train'} "
        "<= set(mods), mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC),
                                         "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert out.returncode == 0, out.stderr


def test_no_source_file_names_jax_or_the_reference_package():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|"
                     r"from repro(\.| import)|import ml_dtypes|"
                     r"from ml_dtypes)", re.M)
    for path in [*PORT.rglob("*.py"), SRC.parent / "chip_smoke.py"]:
        assert not pat.search(path.read_text()), path


def test_kernel_sources_and_build_flags():
    from repro_torch.kernels import build
    assert {p.stem for p in build.CSRC.glob("*.cu")} == set(build.KERNELS)
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags and "use_fast_math" not in flags
    # keyed by source hash, inside the checkout's ignored build directory
    path = build.library_path("delta_codec")
    assert path.parent == build.BUILD_DIR
    assert build.BUILD_DIR.relative_to(SRC.parent).parts[0] == "build"
    assert path == build.library_path("delta_codec")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has a CUDA toolchain")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["delta_codec"])


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    import torch
    from repro_torch.kernels.delta_codec import delta_codec
    from repro_torch.kernels.queue_advance import queue_advance
    from repro_torch.kernels.ref import delta_codec_ref, queue_advance_ref
    x, r = torch.randn(3, 40), torch.randn(3, 40)
    before = delta_codec.launches
    got = delta_codec(x, r, codec="int8")
    want = delta_codec_ref(x, r, codec="int8")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert delta_codec.launches == before
    with pytest.raises(ValueError, match="codec"):
        delta_codec(x, r, codec="fp8")

    i32 = torch.int32
    state = (torch.zeros(3, 64, dtype=i32), torch.zeros(3, 12, dtype=i32),
             torch.zeros(3, 2), torch.zeros(3), torch.zeros(3, 16, dtype=i32))
    arrivals = torch.randint(0, 6, (3, 8), dtype=i32)
    caps = torch.tensor([[2.5, 3.0, 4.0, 2.0, 8.0, 5.0]]).repeat(3, 1)
    before = queue_advance.launches
    got = queue_advance(*state, arrivals, caps)
    want = queue_advance_ref(*state, arrivals, caps)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert queue_advance.launches == before

    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.packing import pack
    from repro_torch.kernels.ref import (decode_attention_ref,
                                         flash_attention_ref, pack_ref)
    q, k, v = torch.randn(2, 9, 4, 32), torch.randn(2, 9, 2, 32), \
        torch.randn(2, 9, 2, 32)
    before = (flash_attention.launches, decode_attention.launches,
              pack.launches)
    assert torch.equal(flash_attention(q, k, v, causal=True),
                       flash_attention_ref(q, k, v, causal=True))
    assert torch.equal(decode_attention(q[:, :1], k, v, 5),
                       decode_attention_ref(q[:, :1], k, v, 5))
    idx = torch.tensor([3, -1, 0, 8], dtype=torch.int32)
    assert torch.equal(pack(k[0, :, 0], idx), pack_ref(k[0, :, 0], idx))
    assert (flash_attention.launches, decode_attention.launches,
            pack.launches) == before
