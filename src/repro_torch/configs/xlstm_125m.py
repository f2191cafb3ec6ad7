"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks [arXiv:2405.04517].

xLSTM[7:1]-style mix: sLSTM blocks at every 8th layer (indices 0, 8), mLSTM
elsewhere. d_ff=0 ⇒ no separate FFN (the cells carry their own projections).
mLSTM trains in the chunkwise-parallel stabilized form (chunk=128); decode is
the O(1) recurrent form with (C, n, m) matrix-memory state, so both
decode_32k and long_500k run with a constant-size cache.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    slstm_every=8,
    ssm_chunk=128,
))
