"""PyTorch/CUDA port of the FCPO fleet trainer.

A second package beside ``repro`` (the JAX reference), with module paths
mirroring it. It imports ``torch`` and numpy only: nothing of JAX and
nothing of ``repro``. Entry points run on the GPU (``device="cuda"``) unless
the caller asks for the CPU; a CUDA request on a machine without CUDA
raises instead of moving to the CPU.

Hand-written Hopper kernels (``repro_torch.kernels``) carry the hot paths
that the JAX package wrote in Pallas; each wrapper launches its kernel for
CUDA tensors and runs its plain PyTorch version for CPU tensors.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    absent (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev
