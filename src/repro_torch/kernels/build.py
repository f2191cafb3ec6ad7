"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C launch function (no PyTorch
headers, so a build takes seconds). It is compiled at first use into
``build/kernels/<name>-<hash>.so`` at the root of the checkout (listed in
``.gitignore``), keyed by a hash of the source and the flags, and loaded
with ``ctypes``. Flags (``flags(name)``): ``-gencode
arch=compute_90a,code=sm_90a -O3`` (Hopper), no ``--use_fast_math`` (so
division, ``sqrtf``, ``expf`` and ``logf`` are IEEE-rounded), and for the
kernels held bit for bit or within a float band against their plain
versions (K1 ``diversity_insert``, K2 ``delta_codec``, K3 ``queue_advance``,
K6 ``pack``) ``-fmad=false``, so that no ``a*b+c`` is contracted into an
FMA the PyTorch reference does not perform (and ``span_stamp``, which
has no arithmetic to contract). K4 ``flash_attention`` and K5
``decode_attention`` are held within a tolerance and build without it, so
their softmax rescaling contracts into FMAs. A build or load error raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
KERNELS = ("diversity_insert", "delta_codec", "queue_advance",
           "decode_attention", "flash_attention", "pack", "span_stamp")
CONTRACTED = ("decode_attention", "flash_attention")   # no -fmad=false

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def flags(name: str) -> tuple:
    """The nvcc flags kernel ``name`` is built with."""
    if name in CONTRACTED:
        return tuple(f for f in NVCC_FLAGS if f != "-fmad=false")
    return NVCC_FLAGS


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built; returns
    (process or None, output path, log path)."""
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        return None, out, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out, log


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Build every named kernel library, all ``nvcc`` runs in parallel.
    Returns {name: .so path}; raises with the compiler output on failure.
    The ``-Xptxas -v`` report (registers, shared memory, spills) is kept
    beside each library as ``.log``."""
    started = {n: _start(n) for n in names}
    errors = []
    for name, (job, out, log) in started.items():
        if job is None:
            continue
        proc, tmp = job
        text, _ = proc.communicate()
        log.write_text(text)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):"
                          f"\n{text}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: out for n, (_, out, _) in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    if name not in _LIBS:
        path = build([name])[name]
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if ``name``'s launch function returned a CUDA error code
    (``cudaGetLastError`` right after the launch)."""
    if rc != 0:
        err = getattr(lib, f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: "
                           f"{err(rc).decode()}")


def check_tensors(kernel: str, device, **tensors) -> None:
    """Raise unless every named tensor is contiguous, on ``device`` (a CUDA
    device) and 16-byte aligned (the kernels' vector loads)."""
    for name, x in tensors.items():
        if x.device != device:
            raise ValueError(f"{kernel}: {name} is on {x.device}, expected "
                             f"{device}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")
