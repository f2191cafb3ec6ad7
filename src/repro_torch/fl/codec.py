"""Per-leaf delta codec over the stacked fleet's parameters.

Port of ``repro.fl.codec``: clients transmit ``params - base`` deltas,
encoded per leaf with error feedback — the residual of every lossy round is
kept per agent and added back before the next encode. Each stacked
(A, ...) leaf is flattened to (A, L) rows with its own scale (int8) and
budget ``k = topk_k(L, frac)`` (topk), and goes through the K2
``delta_codec`` kernel (one launch per leaf on the GPU, the plain version on
the CPU).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.fl.transport import TransportConfig, topk_k
from repro_torch.kernels.delta_codec import delta_codec


def codec_roundtrip(delta: Dict[str, torch.Tensor],
                    residual: Dict[str, torch.Tensor],
                    transport: TransportConfig):
    """Encode->decode a fleet's deltas with error feedback. Returns
    (decoded, new_residual) dicts with ``decoded + new_residual == delta +
    residual`` per leaf (bit-exact for float32/topk)."""
    decoded, new_res = {}, {}
    for name, d in delta.items():
        a = d.shape[0]
        df = d.reshape(a, -1).contiguous()
        rf = residual[name].reshape(a, -1).contiguous()
        k = topk_k(df.shape[1], transport.topk_frac)
        dec, nr = delta_codec(df, rf, codec=transport.codec, k=k)
        decoded[name], new_res[name] = dec.reshape(d.shape), nr.reshape(d.shape)
    return decoded, new_res


def residuals_init(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero error-feedback residuals matching stacked params."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
