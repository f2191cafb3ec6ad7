"""Per-leaf delta codec over the stacked fleet's parameters.

Port of ``repro.fl.codec``: clients transmit ``params - base`` deltas,
encoded per leaf with error feedback — the residual of every lossy round is
kept per agent and added back before the next encode. Each stacked
(A, ...) leaf is flattened to (A, L) rows with its own scale (int8) and
budget ``k = topk_k(L, frac)`` (topk), and all leaves of the round go
through the K2 kernel together (``delta_codec_leaves``: one launch per
round on the GPU for the iAgent's 12 leaves, the plain version per leaf on
the CPU).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.fl.transport import TransportConfig, topk_k
from repro_torch.kernels.delta_codec import delta_codec_leaves


def codec_roundtrip(delta: Dict[str, torch.Tensor],
                    residual: Dict[str, torch.Tensor],
                    transport: TransportConfig):
    """Encode->decode a fleet's deltas with error feedback. Returns
    (decoded, new_residual) dicts with ``decoded + new_residual == delta +
    residual`` per leaf (bit-exact for float32/topk). The deltas are
    float32; residuals stored narrower (a state policy) are read up to
    float32, and both outputs are float32 (the caller stores the residuals
    back at their dtype)."""
    flat = lambda x: x.reshape(x.shape[0], -1).contiguous()
    names = list(delta)
    ds = [flat(delta[n]) for n in names]
    decs, ress = delta_codec_leaves(
        ds, [flat(residual[n].float()) for n in names], codec=transport.codec,
        ks=[topk_k(d.shape[1], transport.topk_frac) for d in ds])
    return ({n: x.reshape(delta[n].shape) for n, x in zip(names, decs)},
            {n: x.reshape(delta[n].shape) for n, x in zip(names, ress)})


def residuals_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero error-feedback residuals matching stacked params."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
