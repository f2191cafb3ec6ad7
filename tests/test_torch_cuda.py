"""The port's CUDA kernels on the card (marker ``cuda``; skipped without a
GPU). This file imports neither JAX nor ``repro``, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX). K1 is held against its
plain version within rtol 1e-4 / atol 1e-5 with identical decision traces,
a first divergence accepted only at a near-tie (score gap below 1e-5
relative); K2 and K3 bit for bit; the trainer must launch the kernels. The
graph driver (CUDA graphs of the episode, FL round and pod merge) and the
graphed twin harness are held bit for bit against the eager runs, also
under the bf16 and lean state policies (every leaf at its stored dtype,
the generators' states equal), and a run resumed from a checkpoint is the
straight run bit for bit. With the health observatory and a metrics sink
the graph driver is the reference driver bit for bit (streamed records
included), and a health run on the card stays within rtol 1e-3 / atol
1e-4 of the same run on the CPU. The span stamp writes its plain
version's slots, the recording K3 equals its plain version bit for bit
(unrecorded results unchanged), and a traced graph run is the untraced
run bit for bit.

The paper's comparison set runs here too: K1 at BCEdge's N=700, NA=13;
the single-head fleet's graph driver against its reference driver bit
for bit; the single-agent K3 against the plain advance and the Python
oracle; ``buffer_insert`` (K1 at T=1) against the CPU; and the static
baselines card against CPU.

The fleet mesh: ``train_fleet --mesh fleet`` on one NCCL rank under the
graph driver equals ``--mesh none`` bit for bit, and two gloo ranks
sharing the card (spawned ``tests/torch_mesh_rank.py``) equal the
meshless card run within rtol/atol 1e-5; on a machine with two or more
cards, NCCL ranks one card each under the graph driver equal the
one-card meshless graph run within rtol/atol 1e-5.

The transformer family: reduced deepseek-v2-lite (MLA, a dense first
layer, MoE with a shared expert) and granite-moe on the card against the
CPU (logits within rtol 1e-3 / atol 1e-4, cache-less and through the
cache; the first MoE layer's routing equal), the MoE combine bit for bit
across calls and against the CPU's, and ``serve --arch <moe> --reduced``
launching K1 once per episode and K5 only in granite's GQA layers.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.fcpo import FCPOConfig
from repro_torch.core.buffer import RIDGE, buffer_init
from repro_torch.fl.transport import topk_k
from repro_torch.kernels.delta_codec import delta_codec, delta_codec_leaves
from repro_torch.kernels.diversity import diversity_insert
from repro_torch.kernels.queue_advance import queue_advance
from repro_torch.kernels.ref import (delta_codec_ref, diversity_insert_ref,
                                     queue_advance_ref)

LEAF_SIZES = (512, 64, 3072, 48, 48, 1, 192, 4, 364, 7, 208, 4)
KW = dict(alpha=0.5, beta=0.5, ridge=RIDGE)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def k1_inputs(rng, a, fill, t, n=64, n_mt=4):
    cfg = FCPOConfig(buffer_size=n, n_mt=n_mt)
    na = cfg.n_res + cfg.n_bs + cfg.n_mt
    b = buffer_init(cfg, a, "cpu")
    state = [b.states, b.probs, b.score, b.filled, b.s_sum, b.s_outer,
             b.p_sum, b.n_filled]

    def cands(n):
        s = torch.tensor(rng.normal(size=(a, n, 8)) * 2.0, dtype=torch.float32)
        p = torch.softmax(torch.tensor(rng.normal(size=(a, n, na)),
                                       dtype=torch.float32), -1)
        return s, p

    if fill:
        state = list(diversity_insert_ref(*state, *cands(fill), **KW)[:8])
    return state + list(cands(t))


def assert_k1_matches(args, device, equal_nan=False):
    """K1 on the card against its plain version on the CPU: one launch,
    identical decision traces except a first divergence at a near-tie
    (score gap below 1e-5 relative), floats within rtol 1e-4 / atol 1e-5
    on the agents that did not diverge (NaN where the plain version has
    NaN, with ``equal_nan``). Returns the kernel's outputs."""
    before = diversity_insert.launches
    out_k = [x.cpu() for x in diversity_insert(
        *[x.to(device) for x in args], **KW)]
    assert diversity_insert.launches == before + 1
    out_p = diversity_insert_ref(*args, **KW)
    diff = (out_k[8] != out_p[8]) | (out_k[9] != out_p[9])
    for a in torch.nonzero(diff.any(1)).flatten().tolist():
        t = int(torch.nonzero(diff[a])[0])
        score = (diversity_insert_ref(*args[:8], args[8][:, :t],
                                      args[9][:, :t], **KW)[2] if t
                 else args[2])[a]
        m = float(score.min())
        gaps = [abs(float(out_k[10][a, t]) - m),
                abs(float(out_p[10][a, t]) - m)]
        if out_k[8][a, t] != out_p[8][a, t]:
            gaps.append(abs(float(score[out_k[8][a, t]]
                                  - score[out_p[8][a, t]])))
        assert min(gaps) <= 1e-5 * max(1.0, abs(float(out_p[10][a, t]))), \
            f"agent {a} diverges at t={t} with no near-tie ({gaps})"
    keep = ~diff.any(1)
    for k, p in zip(out_k, out_p):
        k, p = k[keep], p[keep]
        if k.is_floating_point():
            torch.testing.assert_close(k, p, rtol=1e-4, atol=1e-5,
                                       equal_nan=equal_nan)
        else:
            assert torch.equal(k, p)
    return out_k


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [0, 32, 96])
def test_k1_matches_plain_on_the_card(cuda_device, fill):
    rng = np.random.default_rng(fill)
    assert_k1_matches(k1_inputs(rng, 256, fill, 10), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 7), (3, 7), (5, 1)])
def test_k1_few_slots_match_plain_on_the_card(cuda_device, n, t):
    """Fewer slots than the three lowest scores the kernel keeps, an odd
    number of candidates (the last pair has one), from empty buffers."""
    rng = np.random.default_rng(10 * n + t)
    assert_k1_matches(k1_inputs(rng, 64, 0, t, n), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("a", [8, 2048])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("case", ["tied", "nan", "t1"])
def test_k1_cases_match_plain_on_the_card(cuda_device, a, n, case):
    """Full buffers of N slots: scores tied at the minimum (the lower slot
    goes first), a NaN score (the minimum: nothing goes in), and one
    candidate per agent."""
    rng = np.random.default_rng(a + n + len(case))
    args = k1_inputs(rng, a, n + 8, 1 if case == "t1" else 10, n)
    score = args[2].clone()
    first = torch.clamp_max(score.argmin(-1), 3).to(torch.int32)
    if case == "tied":
        score[:, [3, n // 2, n - 1]] = score.amin(-1, keepdim=True)
    if case == "nan":
        score[:, n // 3] = float("nan")
    args[2] = score
    out_k = assert_k1_matches(args, cuda_device, equal_nan=case == "nan")
    if case == "nan":
        assert (out_k[8] == n // 3).all() and not out_k[9].any()
    if case == "tied":      # the lowest of the tied slots goes first
        assert torch.equal(out_k[8][:, 0], first)


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["float32", "int8", "topk"])
def test_k2_bit_identical_to_plain_on_the_card(cuda_device, codec):
    rng = np.random.default_rng(["float32", "int8", "topk"].index(codec))
    for l in LEAF_SIZES:
        for grid in (False, True):
            if grid:   # exact int8 halfway cases (scale 0.5) and |x| ties
                d = (rng.integers(-254, 255, (64, l)) / 4.0).astype(np.float32)
                d[:, 0] = 63.5
                r = np.zeros_like(d)
            else:
                d = (rng.normal(size=(64, l)) * 0.01).astype(np.float32)
                r = (rng.normal(size=(64, l)) * 0.001).astype(np.float32)
            k = topk_k(l, 0.05)
            before = delta_codec.launches
            dk, rk = delta_codec(torch.tensor(d, device=cuda_device),
                                 torch.tensor(r, device=cuda_device),
                                 codec=codec, k=k)
            assert delta_codec.launches == before + 1
            dp, rp = delta_codec_ref(torch.tensor(d), torch.tensor(r),
                                     codec=codec, k=k)
            bits = lambda x: x.cpu().numpy().view(np.uint32)
            np.testing.assert_array_equal(bits(dk), bits(dp), f"L={l}")
            np.testing.assert_array_equal(bits(rk), bits(rp), f"L={l}")


@pytest.mark.cuda
def test_trainer_launches_both_kernels_on_the_card(cuda_device):
    from repro_torch.launch import train_fleet
    diversity_insert.launches = delta_codec.launches = 0
    _, hist = train_fleet.main(["--agents", "4", "--pods", "2",
                                "--episodes", "3", "--fl-every", "1",
                                "--fl-codec", "int8"])
    assert diversity_insert.launches == 3          # one per episode
    assert delta_codec.launches == 3 * 1           # one per round
    assert all(np.isfinite(v).all() for v in hist.values())


def k3_interval(rng, regime, a, k):
    """Arrivals (A, K) and caps (A, 6) of one interval: idle (0-1 arrivals
    per tick), nominal (the nominal traces' rates, 15-45 req/s at 50 ms
    ticks), overload (3-6x what the caps serve, smallest batch) or wrap
    (service outruns 3-5 arrivals a tick, queues of 4: a ring of 8 is
    written over several times an interval)."""
    if regime == "overload":
        c_post = rng.uniform(0.2, 0.5, a)
        caps = np.stack([rng.uniform(1, 2, a), c_post, np.ones(a),
                         np.ones(a), np.full(a, 8.0), np.full(a, 5.0)], 1)
        arrivals = rng.poisson(rng.uniform(3, 6, (a, 1)) * c_post[:, None],
                               (a, k))
    elif regime == "wrap":
        caps = np.tile([4.0, 4.0, 4.0, 1.0, 4.0, 3.0], (a, 1))
        caps[:, 1] = rng.uniform(3.5, 5.0, a)
        arrivals = rng.integers(3, 6, (a, k))
    else:
        caps = np.stack([rng.uniform(1, 12, a), rng.uniform(1, 14, a),
                         rng.integers(1, 65, a), rng.integers(1, 4, a),
                         np.full(a, 128.0), np.full(a, 5.0)], 1)
        lam = 0.5 if regime == "idle" else rng.uniform(0.75, 2.25, (a, 1))
        arrivals = rng.poisson(lam, (a, k))
        if regime == "idle":
            arrivals = np.minimum(arrivals, 1)
    return (torch.tensor(arrivals, dtype=torch.int32),
            torch.tensor(caps, dtype=torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["idle", "nominal", "overload"])
def test_k3_bit_identical_to_plain_on_the_card(cuda_device, regime):
    """Ten chained intervals at R=512, H=64, K=20, A=256: all five outputs
    equal the plain version's, and the regime did what it is for."""
    rng = np.random.default_rng(["idle", "nominal", "overload"].index(regime))
    a, i32 = 256, torch.int32
    state = [torch.zeros(a, 512, dtype=i32), torch.zeros(a, 12, dtype=i32),
             torch.zeros(a, 2), torch.zeros(a), torch.zeros(a, 64, dtype=i32)]
    for _ in range(10):
        arrivals, caps = k3_interval(rng, regime, a, 20)
        before = queue_advance.launches
        got = queue_advance(*(x.to(cuda_device) for x in state),
                            arrivals.to(cuda_device), caps.to(cuda_device))
        assert queue_advance.launches == before + 1
        want = queue_advance_ref(*state, arrivals, caps)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        state = list(want)
    c = state[1]
    arrived, dropped, completed = c[:, 7], c[:, 8], c[:, 9]
    assert torch.equal(arrived, dropped + completed + c[:, 0] - c[:, 4])
    assert int(completed.sum()) > 0
    assert (int(dropped.sum()) > 0) == (regime == "overload")


# (R, H, K): rings of 8, 32 and 512 slots, one or 64 histogram buckets, one
# or 20 ticks an interval
K3_GEOMETRIES = [(r, h, k) for r in (8, 32, 512) for h in (1, 64)
                 for k in (1, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", K3_GEOMETRIES,
                         ids=[f"R{r}-H{h}-K{k}" for r, h, k in K3_GEOMETRIES])
@pytest.mark.parametrize("regime", ["idle", "nominal", "overload", "wrap"])
def test_k3_regimes_and_geometries_bit_identical_on_the_card(
        cuda_device, regime, geometry):
    """A = 1, 8, 256 and 2048, ten chained intervals from empty pipelines:
    one launch a call, every output equal to the plain version's (on the
    card), the inputs as they were, requests conserved; in the wrap regime
    on a ring of 8, more than R requests admitted in one interval."""
    r, h, k = geometry
    rng = np.random.default_rng(r + h + k + len(regime))
    for a in (1, 8, 256, 2048):
        i32 = dict(dtype=torch.int32, device=cuda_device)
        state = [torch.zeros(a, r, **i32), torch.zeros(a, 12, **i32),
                 torch.zeros(a, 2, device=cuda_device),
                 torch.zeros(a, device=cuda_device), torch.zeros(a, h, **i32)]
        most = 0
        for _ in range(10):
            arrivals, caps = (x.to(cuda_device)
                              for x in k3_interval(rng, regime, a, k))
            args = (*state, arrivals, caps)
            kept = [x.clone() for x in args]
            before = queue_advance.launches
            got = queue_advance(*args)
            assert queue_advance.launches == before + 1
            want = queue_advance_ref(*args)
            for name, g, w in zip(("arrive", "counters", "credits",
                                   "lat_sum", "hist"), got, want):
                assert torch.equal(g, w), f"A={a}: {name} differs"
            assert all(torch.equal(x, y) for x, y in zip(args, kept))
            most = max(most, int((got[1][:, 0] - state[1][:, 0]).max()))
            state = list(got)
        c = state[1]
        assert torch.equal(c[:, 7], c[:, 8] + c[:, 9] + c[:, 0] - c[:, 4])
        if regime == "wrap" and r == 8 and k == 20:
            assert most > r


def codec_leaves(rng, a, device):
    """The 12 iAgent leaves, a leaf of 5,000 values (two chunks of the
    block path) and a leaf of 3,072 that starts 4 bytes past a 16-byte
    boundary (scalar loads). Rows cycle through random deltas with
    residuals, the quarter grid (int8 halfway cases, |x| ties), a row with
    NaN, +inf and -inf, and zeros. Budgets ceil(0.05 L), k = L for the
    leaf of 7."""
    sizes = LEAF_SIZES + (5000, 3072)
    ds, rs = [], []
    for i, l in enumerate(sizes):
        d = (rng.normal(size=(a, l)) * 0.01).astype(np.float32)
        r = (rng.normal(size=(a, l)) * 0.001).astype(np.float32)
        grid = (rng.integers(-254, 255, (a, l)) / 4.0).astype(np.float32)
        grid[:, 0] = 63.5
        d[1::4], r[1::4] = grid[1::4], 0.0
        d[2::4, 0], d[2::4, l // 2], d[2::4, -1] = np.nan, np.inf, -np.inf
        d[3::4], r[3::4] = 0.0, 0.0
        if i == len(sizes) - 1:     # 4 bytes past a 16-byte boundary
            flat = torch.zeros(2 * a * l + 1, device=device)
            dt, rt = flat[1:1 + a * l].view(a, l), flat[1 + a * l:].view(a, l)
            dt.copy_(torch.tensor(d))
            rt.copy_(torch.tensor(r))
            assert dt.data_ptr() % 16 == 4
        else:
            dt, rt = (torch.tensor(x, device=device) for x in (d, r))
        ds.append(dt)
        rs.append(rt)
    ks = [topk_k(l, 0.05) for l in sizes]
    ks[LEAF_SIZES.index(7)] = 7
    return ds, rs, ks


@pytest.mark.cuda
@pytest.mark.parametrize("a", [1, 8, 2048])
@pytest.mark.parametrize("codec", ["float32", "int8", "topk"])
def test_k2_segmented_bit_identical_to_plain_on_the_card(cuda_device, codec,
                                                         a):
    """``delta_codec_leaves`` over 14 leaves in one launch, every output
    bit for bit (NaN payloads included) the plain version's on the card."""
    ds, rs, ks = codec_leaves(np.random.default_rng(a), a, cuda_device)
    before = delta_codec.launches
    decs, ress = delta_codec_leaves(ds, rs, codec=codec, ks=ks)
    assert delta_codec.launches == before + 1
    bits = lambda x: x.view(torch.int32)
    for d, r, k, dec, res in zip(ds, rs, ks, decs, ress):
        want = delta_codec_ref(d, r, codec=codec, k=k)
        assert torch.equal(bits(dec), bits(want[0])), f"L={d.shape[1]}"
        assert torch.equal(bits(res), bits(want[1])), f"L={d.shape[1]}"


@pytest.mark.cuda
def test_twin_trainer_launches_k3_once_per_interval(cuda_device):
    from repro_torch.launch import train_fleet
    queue_advance.launches = diversity_insert.launches = 0
    _, hist = train_fleet.main(["--agents", "4", "--pods", "2",
                                "--episodes", "3", "--env-backend", "twin"])
    assert queue_advance.launches == 3 * 10        # n_steps per episode
    assert diversity_insert.launches == 3
    assert all(np.isfinite(v).all() for v in hist.values())


# ---------------------------------------------------------------------------
# K4 flash_attention, K5 decode_attention, K6 pack, and the LM engine
# ---------------------------------------------------------------------------
# the JAX tests' sweeps (tests/test_kernels.py), plus the port's shapes
FLASH_CASES = [
    # (b, sq, sk, hq, hkv, d, dtype, causal)
    (2, 128, 128, 4, 4, 64, torch.float32, True),
    (2, 128, 128, 4, 2, 64, torch.float32, True),
    (1, 256, 256, 8, 1, 64, torch.float32, True),
    (1, 128, 128, 4, 4, 128, torch.bfloat16, True),
    (1, 128, 128, 2, 2, 256, torch.float32, True),
    (2, 128, 128, 4, 4, 80, torch.float32, False),
    (1, 384, 384, 7, 1, 64, torch.float32, True),
    (2, 50, 70, 4, 2, 32, torch.float32, False),
    (2, 512, 512, 14, 2, 64, torch.bfloat16, True),
]
DECODE_CASES = [
    # (b, hq, hkv, d, s_max, kv_len, q dtype, cache dtype)
    (2, 4, 4, 64, 256, 256, torch.float32, torch.float32),
    (2, 4, 2, 64, 512, 300, torch.float32, torch.float32),
    (1, 8, 2, 128, 512, 77, torch.float32, torch.float32),
    (1, 14, 2, 64, 512, 500, torch.float32, torch.float32),
    (1, 4, 4, 128, 256, 128, torch.bfloat16, torch.bfloat16),
    (2, 16, 16, 256, 256, 199, torch.float32, torch.float32),
    (8, 14, 2, 64, 256, 17, torch.bfloat16, torch.bfloat16),
    (3, 4, 2, 32, 48, 17, torch.float32, torch.bfloat16),
]


# K4's bf16 path (wgmma, TMA) on every shape of the sweep
FLASH_BF16_CASES = [c[:6] + (torch.bfloat16, c[7]) for c in FLASH_CASES
                    if c[6] == torch.float32]
# K5 with several splits of the cache prefix and a combine: kv_len 4096 at
# B=2, kv_len one past a split boundary, a long S_max with a short kv_len,
# D=80 and 256, and a group of 16 query heads (two head chunks)
DECODE_SPLIT_CASES = [
    (2, 14, 2, 64, 4096, 4096, torch.bfloat16, torch.bfloat16),
    (2, 4, 2, 64, 4352, 4097, torch.float32, torch.float32),
    (2, 4, 2, 32, 4352, 4097, torch.float32, torch.bfloat16),
    (1, 8, 2, 128, 8192, 300, torch.float32, torch.float32),
    (1, 4, 1, 80, 2048, 1500, torch.bfloat16, torch.bfloat16),
    (1, 16, 16, 256, 1024, 1000, torch.float32, torch.float32),
    (1, 16, 1, 64, 1024, 700, torch.bfloat16, torch.bfloat16),
]


def attn_tol(dtype):
    return 2e-2 if dtype == torch.bfloat16 else 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_k4_matches_plain_on_the_card(cuda_device, case):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    b, sq, sk, hq, hkv, d, dtype, causal = case
    gen = torch.Generator(device=cuda_device).manual_seed(sq + d)
    q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(dtype)
               for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=attn_tol(dtype), atol=attn_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BF16_CASES)
def test_k4_bf16_matches_plain_on_the_card(cuda_device, case):
    test_k4_matches_plain_on_the_card(cuda_device, case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_CASES)
def test_k5_matches_plain_on_the_card(cuda_device, case):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.ref import decode_attention_ref
    b, hq, hkv, d, s_max, kv_len, qt, ct = case
    gen = torch.Generator(device=cuda_device).manual_seed(s_max + d)
    q = torch.randn((b, 1, hq, d), generator=gen, device=cuda_device).to(qt)
    kc, vc = (torch.randn((b, s_max, hkv, d), generator=gen,
                          device=cuda_device).to(ct) for _ in range(2))
    before = decode_attention.launches
    got = decode_attention(q, kc, vc, kv_len)
    assert decode_attention.launches == before + 1
    want = decode_attention_ref(q, kc, vc, kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=attn_tol(qt),
                               atol=attn_tol(qt))
    # garbage past kv_len never enters the result
    kc[:, kv_len:], vc[:, kv_len:] = 1e9, float("nan")
    assert torch.equal(decode_attention(q, kc, vc, kv_len), got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECODE_SPLIT_CASES)
def test_k5_splits_match_plain_on_the_card(cuda_device, case):
    from repro_torch.kernels.decode_attention import num_splits
    b, hq, hkv, _, _, kv_len = case[:6]
    assert num_splits(b, hkv, kv_len) > 1
    test_k5_matches_plain_on_the_card(cuda_device, case)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_k6_bit_identical_to_plain_on_the_card(cuda_device, dtype):
    from repro_torch.kernels.packing import pack
    from repro_torch.kernels.ref import pack_ref
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for t, d, n in ((64, 128, 8), (4096, 896, 8192), (33, 3, 100)):
        tok = (torch.randn((t, d), generator=gen, device=cuda_device) * 10
               ).to(dtype)
        idx = torch.randint(-t // 9, t + 2, (n,), generator=gen,
                            device=cuda_device, dtype=torch.int32)
        before = pack.launches
        got = pack(tok, idx)
        assert pack.launches == before + 1
        want = pack_ref(tok, idx)
        bits = lambda x: x.view(torch.int16 if x.element_size() == 2
                                else torch.int32)
        assert torch.equal(bits(got), bits(want))


def k6_case(name, device, gen):
    """(tokens, indices) of the K6 edge cases: every row padding, one row,
    N not a multiple of the 8 rows a block takes, bf16 rows of 1,792 bytes
    (D=896), and tokens 4 or 1 bytes past a 16-byte boundary (the 4- and
    1-byte word paths)."""
    t, d, n, dtype = dict(all_padding=(64, 896, 300, torch.float32),
                          n1=(64, 896, 1, torch.float32),
                          ragged_n=(4096, 896, 8193, torch.float32),
                          bf16_1792=(4096, 896, 8192, torch.bfloat16),
                          offset4=(512, 896, 1000, torch.float32),
                          offset1=(512, 893, 1000, torch.uint8))[name]
    if dtype == torch.uint8:
        flat = torch.randint(0, 256, (t * d + 1,), generator=gen,
                             device=device, dtype=torch.uint8)
    else:
        flat = (torch.randn((t * d + 1,), generator=gen, device=device) * 10
                ).to(dtype)
    tok = flat[1:].view(t, d) if name.startswith("offset") else \
        flat[:-1].view(t, d)
    idx = torch.randint(-t // 9, t + 2, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    if name == "all_padding":
        idx = -1 - idx.abs()
    return tok, idx


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["all_padding", "n1", "ragged_n",
                                  "bf16_1792", "offset4", "offset1"])
def test_k6_edge_cases_bit_identical_to_plain_on_the_card(cuda_device, name):
    from repro_torch.kernels.packing import pack
    from repro_torch.kernels.ref import pack_ref
    gen = torch.Generator(device=cuda_device).manual_seed(len(name))
    tok, idx = k6_case(name, cuda_device, gen)
    if name == "offset4":
        assert tok.data_ptr() % 16 == 4
    if name == "offset1":
        assert tok.data_ptr() % 2 == 1
    before = pack.launches
    got = pack(tok, idx)
    assert pack.launches == before + 1
    want = pack_ref(tok, idx)
    bits = {2: torch.int16, 4: torch.int32, 1: torch.uint8}[
        tok.element_size()]
    assert torch.equal(got.view(bits), want.view(bits))
    if name == "all_padding":
        assert not got.view(bits).any()


@pytest.mark.cuda
def test_engine_decode_launches_k5_in_every_layer(cuda_device):
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("qwen2-0.5b").reduced().replace(n_layers=3)
    model = get_model(cfg)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    engines = [ServingEngine(model, params, max_cache_len=64,
                             batch_buckets=(4,), seq_buckets=(16,),
                             cache_dtype=torch.float32, use_kernels=uk)
               for uk in (True, False)]
    tok = torch.randint(0, cfg.vocab_size, (3, 16), dtype=torch.int32)
    decode_attention.launches = flash_attention.launches = 0
    out = engines[0].generate(tok, steps=5)
    assert decode_attention.launches == 4 * 3      # per decode step, layer
    assert flash_attention.launches == 0           # prefill into the cache
    assert torch.equal(out, engines[1].generate(tok, steps=5))
    assert decode_attention.launches == 4 * 3


# ---------------------------------------------------------------------------
# The graph driver and the graphed twin harness
# ---------------------------------------------------------------------------
SRC = Path(__file__).resolve().parents[1] / "src"


def recorded_actions(monkeypatch, n, a, device):
    """Record every control step's (A, 3) actions into a device buffer (a
    recording that CUDA-graph capture keeps): returns the (n, A, 3)
    buffer."""
    from repro_torch.core import crl
    from repro_torch.core.agent import sample_actions as sample
    rec = torch.full((n, a, 3), -1, dtype=torch.long, device=device)
    pos = torch.zeros((), dtype=torch.long, device=device)

    def recording(*args, **kw):
        out = sample(*args, **kw)
        rec.index_copy_(0, pos.view(1), out[0][None])
        pos.add_(1)
        return out

    monkeypatch.setattr(crl, "sample_actions", recording)
    return rec


def assert_trees_equal(got, want, prefix=""):
    """Nested numpy dicts (``fleet_to_numpy``) equal bit for bit."""
    for k, v in want.items():
        if isinstance(v, dict):
            assert_trees_equal(got[k], v, f"{prefix}{k}.")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                          err_msg=f"{prefix}{k}")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fluid", "twin"])
@pytest.mark.parametrize("codec", ["float32", "int8", "topk"])
def test_graph_driver_matches_reference_on_the_card(cuda_device, monkeypatch,
                                                    backend, codec):
    """A=8, P=2, ``fl_every=1``, eight episodes (two pod merges), Bernoulli
    stragglers, action noise from the fleet's generator: the graph driver
    takes the reference driver's actions, and its histories, final state
    and kernel launch counts are the reference's bit for bit."""
    from repro_torch.core import fleet as tfleet
    from repro_torch.fl.transport import TransportConfig
    cfg = FCPOConfig(fl_every=1)
    a, n_eps = 8, 8
    traces = torch.tensor(np.random.default_rng(5).uniform(
        5.0, 160.0, (a, n_eps * cfg.n_steps)).astype(np.float32),
        device=cuda_device)
    runs = []
    for drive in (tfleet.train_fleet_reference, tfleet.train_fleet_scan):
        rec = recorded_actions(monkeypatch, n_eps * cfg.n_steps, a,
                               cuda_device)
        fleet = tfleet.fleet_init(cfg, a, 11, n_pods=2, device=cuda_device,
                                  env_backend=backend)
        diversity_insert.launches = delta_codec.launches = 0
        queue_advance.launches = 0
        fleet, hist = drive(cfg, fleet, traces, straggler_prob=0.25, seed=3,
                            env_backend=backend,
                            transport=TransportConfig(codec=codec))
        runs.append((rec.cpu(), hist, tfleet.fleet_to_numpy(fleet),
                     (diversity_insert.launches, delta_codec.launches,
                      queue_advance.launches)))
    (act_r, hist_r, state_r, n_r), (act_s, hist_s, state_s, n_s) = runs
    assert (act_r >= 0).all() and torch.equal(act_s, act_r)
    assert set(hist_s) == set(hist_r)
    for k, v in hist_r.items():
        np.testing.assert_array_equal(hist_s[k], v, err_msg=k)
    assert_trees_equal(state_s, state_r)
    want_k2 = n_eps if codec != "float32" else 0
    want_k3 = n_eps * cfg.n_steps if backend == "twin" else 0
    assert n_s == n_r == (n_eps, want_k2, want_k3)


@pytest.mark.cuda
def test_graph_capture_error_raises_on_the_card(cuda_device):
    """A body that syncs with the host (``.item()``) cannot be captured:
    ``GraphedBody`` raises after its eager first step, and does not fall
    back. Run in its own process, since a failed capture may leave the CUDA
    context unusable."""
    script = (
        "import torch\n"
        "from repro_torch.core.graphs import GraphedBody\n"
        "x = torch.ones(4, device='cuda')\n"
        "seen = []\n"
        "body = GraphedBody(lambda: seen.append(float(x.sum().item())),\n"
        "                   torch.device('cuda'))\n"
        "try:\n"
        "    body()\n"
        "except RuntimeError:\n"
        "    raise SystemExit(0 if seen == [4.0] and body.graph is None "
        "else 3)\n"
        "raise SystemExit(2)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.cuda
def test_graph_capture_runs_without_the_cyclic_gc(cuda_device):
    """The cyclic collector is off while a body is captured (a graph freed
    from a reference cycle mid-capture would invalidate it) and back on
    after; the eager first step runs with it on."""
    import gc
    from repro_torch.core.graphs import GraphedBody
    x = torch.zeros(4, device=cuda_device)
    seen = []
    body = GraphedBody(lambda: (seen.append(gc.isenabled()), x.add_(1)),
                       cuda_device)
    body()
    body()
    torch.cuda.synchronize()
    assert seen == [True, False] and gc.isenabled()
    assert body.replays == 1 and torch.equal(x, torch.full_like(x, 2.0))


@pytest.mark.cuda
def test_graphed_simulate_matches_eager_on_the_card(cuda_device):
    """``simulate_fleet`` (one graph for the interval body, replayed) against
    the same interval loop run eagerly on the card, noise from generators
    of one seed: the final twin state, the history and K3's launch count
    are equal."""
    from repro_torch.core.agent import sample_actions
    from repro_torch.core.fleet import fleet_init
    from repro_torch.sim.harness import (HISTORY_KEYS, sim_observe,
                                         simulate_fleet)
    from repro_torch.sim.state import (SimParams, action_caps, sim_init,
                                       spread_arrivals)
    from repro_torch.sim.step import sim_interval
    cfg, sp, a, n_int = FCPOConfig(), SimParams(), 8, 30
    fleet = fleet_init(cfg, a, 2, device=cuda_device)
    params = fleet.astate.policy.params()
    traces = torch.tensor(np.random.default_rng(6).uniform(
        5.0, 200.0, (a, n_int)).astype(np.float32), device=cuda_device)
    gen = lambda: torch.Generator(device=cuda_device).manual_seed(9)

    queue_advance.launches = 0
    state, hist, _ = simulate_fleet(cfg, sp, params, fleet.masks,
                                    fleet.env_params, traces,
                                    generator=gen())
    assert queue_advance.launches == n_int

    g = gen()
    st = sim_init(sp, a, cuda_device)
    drops = torch.zeros(a, dtype=torch.int32, device=cuda_device)
    act = torch.zeros(a, 3, dtype=torch.long, device=cuda_device)
    phase = torch.zeros(a, device=cuda_device)
    rows = []
    with torch.no_grad():
        for t in range(n_int):
            rate = traces[:, t]
            obs = sim_observe(cfg, sp, fleet.env_params, st, drops, act, rate)
            act, _, _ = sample_actions(cfg, params, obs, fleet.masks,
                                       generator=g)
            arrivals, phase = spread_arrivals(sp, rate, phase)
            st2 = sim_interval(st, arrivals,
                               action_caps(cfg, sp, fleet.env_params, act))
            rows.append((st2.completed - st.completed).float())
            drops = st2.dropped - st.dropped
            st = st2
    for got, want in zip(state.tensors(), st.tensors()):
        assert torch.equal(got, want)
    np.testing.assert_array_equal(
        hist["throughput"], (torch.stack(rows) / sp.interval_s).cpu().numpy())
    assert set(hist) == set(HISTORY_KEYS)


def chaos_kwargs(codec="int8"):
    """The chaos slice: async rounds with a deadline some links miss, the
    trimmed mean, the delta clip, crash / byzantine / partition faults."""
    from repro_torch.fl.transport import TransportConfig
    from repro_torch.resilience.faults import FaultConfig
    from repro_torch.resilience.guards import GuardConfig
    return dict(
        transport=TransportConfig(codec=codec, deadline_s=0.002,
                                  async_rounds=True),
        guards=GuardConfig(agg="trimmed", clip_factor=3.0),
        faults=FaultConfig(crash_prob=0.1, byzantine_frac=0.25,
                           partition_prob=0.3))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fluid", "twin"])
def test_graph_driver_matches_reference_under_chaos_on_the_card(
        cuda_device, monkeypatch, backend):
    """The chaos slice (A=8, P=2, ``fl_every=1``, eight episodes, two
    merges): the graph driver takes the reference driver's actions, and
    its histories, final state (timers and parked uploads included) and
    launch counts are the reference's bit for bit; K2 once per round."""
    from repro_torch.core import fleet as tfleet
    cfg = FCPOConfig(fl_every=1)
    a, n_eps = 8, 8
    traces = torch.tensor(np.random.default_rng(5).uniform(
        5.0, 160.0, (a, n_eps * cfg.n_steps)).astype(np.float32),
        device=cuda_device)
    runs = []
    for drive in (tfleet.train_fleet_reference, tfleet.train_fleet_scan):
        rec = recorded_actions(monkeypatch, n_eps * cfg.n_steps, a,
                               cuda_device)
        fleet = tfleet.fleet_init(cfg, a, 11, n_pods=2, device=cuda_device,
                                  env_backend=backend)
        diversity_insert.launches = delta_codec.launches = 0
        queue_advance.launches = 0
        fleet, hist = drive(cfg, fleet, traces, straggler_prob=0.25, seed=3,
                            env_backend=backend, **chaos_kwargs())
        runs.append((rec.cpu(), hist, tfleet.fleet_to_numpy(fleet),
                     (diversity_insert.launches, delta_codec.launches,
                      queue_advance.launches)))
    (act_r, hist_r, state_r, n_r), (act_s, hist_s, state_s, n_s) = runs
    assert (act_r >= 0).all() and torch.equal(act_s, act_r)
    for k, v in hist_r.items():
        np.testing.assert_array_equal(hist_s[k], v, err_msg=k)
    assert_trees_equal(state_s, state_r)
    assert n_s == n_r == (n_eps, n_eps,
                          n_eps * cfg.n_steps if backend == "twin" else 0)
    assert hist_s["fl_stale_used"].sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_chaos_card_run_matches_cpu_run(cuda_device, codec):
    """The chaos slice from one numpy fleet state with one set of action
    noise, on the card (kernels) and on the CPU (plain versions):
    histories within rtol 1e-3 / atol 1e-4; timers and the parked
    uploads' masks identical."""
    from repro_torch.core import fleet as tfleet
    cfg = FCPOConfig(fl_every=1)
    a, n_eps = 4, 8
    tree = tfleet.fleet_to_numpy(tfleet.fleet_init(cfg, a, 7, n_pods=2,
                                                   device="cpu"))
    rng = np.random.default_rng(7)
    traces = rng.uniform(5.0, 120.0, (a, n_eps * cfg.n_steps)).astype(
        np.float32)
    gumbel = (-np.log(-np.log(rng.uniform(
        1e-6, 1.0, (n_eps, a, cfg.n_steps, 15))))).astype(np.float32)
    out = []
    for dev in (cuda_device, "cpu"):
        fleet = tfleet.fleet_from_numpy(cfg, tree, device=dev)
        fleet, hist = tfleet.train_fleet_scan(
            cfg, fleet, torch.as_tensor(traces, device=dev),
            gumbel=torch.as_tensor(gumbel, device=dev),
            **chaos_kwargs(codec))
        out.append((hist, tfleet.fleet_to_numpy(fleet)))
    (hist_k, st_k), (hist_c, st_c) = out
    for k, v in hist_c.items():
        np.testing.assert_allclose(hist_k[k], v, rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    for k in ("crash_timer", "partition_timer"):
        np.testing.assert_array_equal(st_k[k], st_c[k], err_msg=k)
    for k in ("has", "staleness"):
        np.testing.assert_array_equal(st_k["pending"][k], st_c["pending"][k],
                                      err_msg=k)


# ---------------------------------------------------------------------------
# state dtype policies and checkpoint resume on the card
# ---------------------------------------------------------------------------
def noise_chaos():
    """The chaos slice with byzantine ``noise`` (drawn from the fleet's
    fault generator, registered with the FL-round graph)."""
    from repro_torch.resilience.faults import FaultConfig
    kw = chaos_kwargs()
    kw["faults"] = FaultConfig(crash_prob=0.1, byzantine_frac=0.25,
                               byzantine_mode="noise", byzantine_scale=2.0,
                               partition_prob=0.3)
    return kw


def raw(x):
    """A numpy leaf's bits (bf16 ``|V2`` leaves as uint16)."""
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint16) if x.dtype.kind == "V" else x


def assert_raw_equal(got, want, prefix=""):
    for k, v in want.items():
        if isinstance(v, dict):
            assert_raw_equal(got[k], v, f"{prefix}{k}.")
        else:
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(raw(got[k]), raw(v),
                                          err_msg=f"{prefix}{k}")


def assert_generators_equal(a, b):
    for name in ("generator", "fault_generator"):
        ga, gb = getattr(a, name), getattr(b, name)
        assert (ga is None) == (gb is None), name
        if ga is not None:
            assert torch.equal(ga.get_state(), gb.get_state()), name


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fluid", "twin"])
@pytest.mark.parametrize("policy", ["bf16", "lean"])
def test_graph_driver_matches_reference_per_policy_on_the_card(
        cuda_device, monkeypatch, policy, backend):
    """A bf16 / lean fleet (A=8, P=2, ``fl_every=1``, eight episodes)
    under the chaos slice with byzantine noise: the graph driver takes the
    reference driver's actions; its histories, final state (every leaf at
    its stored dtype) and launch counts are the reference's bit for bit,
    and the Philox offsets its replays advanced are the ones
    ``get_state()`` reports, equal to the eager driver's."""
    from repro_torch.core import fleet as tfleet
    cfg = FCPOConfig(fl_every=1)
    a, n_eps = 8, 8
    traces = torch.tensor(np.random.default_rng(5).uniform(
        5.0, 160.0, (a, n_eps * cfg.n_steps)).astype(np.float32),
        device=cuda_device)
    runs = []
    for drive in (tfleet.train_fleet_reference, tfleet.train_fleet_scan):
        rec = recorded_actions(monkeypatch, n_eps * cfg.n_steps, a,
                               cuda_device)
        fleet = tfleet.fleet_init(cfg, a, 11, n_pods=2, device=cuda_device,
                                  env_backend=backend, state_policy=policy)
        diversity_insert.launches = delta_codec.launches = 0
        queue_advance.launches = 0
        fleet, hist = drive(cfg, fleet, traces, straggler_prob=0.25, seed=3,
                            env_backend=backend, **noise_chaos())
        runs.append((rec.cpu(), hist, fleet,
                     (diversity_insert.launches, delta_codec.launches,
                      queue_advance.launches)))
    (act_r, hist_r, f_r, n_r), (act_s, hist_s, f_s, n_s) = runs
    assert (act_r >= 0).all() and torch.equal(act_s, act_r)
    for k, v in hist_r.items():
        np.testing.assert_array_equal(hist_s[k], v, err_msg=k)
    assert_raw_equal(tfleet.fleet_to_numpy(f_s), tfleet.fleet_to_numpy(f_r))
    assert_generators_equal(f_s, f_r)
    assert f_s.astate.opt["m"]["head_bs.w"].dtype == torch.bfloat16
    assert n_s == n_r == (n_eps, n_eps,
                          n_eps * cfg.n_steps if backend == "twin" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fluid", "twin"])
def test_resume_on_the_card_is_the_straight_run(cuda_device, tmp_path,
                                                backend):
    """The graph driver on a lean fleet under the chaos slice with noise:
    eight episodes straight, against three, a checkpoint, a restore into a
    fresh fleet and five more: histories, final state and both generators'
    states bit for bit. The checkpoint also restores on the CPU, every
    leaf equal."""
    from repro_torch.core import fleet as tfleet
    from repro_torch.training import checkpoint as ckpt
    cfg = FCPOConfig(fl_every=1)
    a, n_eps, cut = 8, 8, 3
    traces = torch.tensor(np.random.default_rng(6).uniform(
        5.0, 160.0, (a, n_eps * cfg.n_steps)).astype(np.float32),
        device=cuda_device)
    mk = lambda dev=cuda_device: tfleet.fleet_init(
        cfg, a, 11, n_pods=2, device=dev, env_backend=backend,
        state_policy="lean")
    kw = dict(straggler_prob=0.25, seed=3, env_backend=backend,
              total_episodes=n_eps, **noise_chaos())
    f_s, h_s = tfleet.train_fleet_scan(cfg, mk(), traces, **kw)
    f_1, h_1 = tfleet.train_fleet_scan(
        cfg, mk(), traces[:, :cut * cfg.n_steps], **kw)
    ckpt.save(str(tmp_path), cut, f_1)
    f_2, manifest = ckpt.restore(str(tmp_path), cut, mk(), cfg)
    assert manifest["restored_generators"] == ["torch/generator",
                                               "torch/fault_generator"]
    f_2, h_2 = tfleet.train_fleet_scan(
        cfg, f_2, traces[:, cut * cfg.n_steps:], episode_offset=cut, **kw)
    for k, v in h_s.items():
        np.testing.assert_array_equal(np.concatenate([h_1[k], h_2[k]]), v,
                                      err_msg=k)
    assert_raw_equal(tfleet.fleet_to_numpy(f_2), tfleet.fleet_to_numpy(f_s))
    assert_generators_equal(f_2, f_s)
    on_cpu, manifest = ckpt.restore(str(tmp_path), cut, mk("cpu"), cfg)
    assert manifest["restored_generators"] == []   # the card's generators
    assert_raw_equal(tfleet.fleet_to_numpy(on_cpu),
                     tfleet.fleet_to_numpy(f_1))


# ---------------------------------------------------------------------------
# the health observatory and the metrics stream on the card
# ---------------------------------------------------------------------------
def health_kwargs(threshold=0.5):
    """The health slice: int8 with a deadline, byzantine sign_flip 0.25,
    the observatory on and the suspicion gate at ``threshold``."""
    from repro_torch.fl.transport import TransportConfig
    from repro_torch.health import HealthConfig
    from repro_torch.resilience.faults import FaultConfig
    from repro_torch.resilience.guards import GuardConfig
    return dict(transport=TransportConfig(codec="int8", deadline_s=0.002),
                faults=FaultConfig(byzantine_frac=0.25),
                guards=GuardConfig(susp_threshold=threshold),
                health=HealthConfig())


class ListSink:
    def __init__(self):
        self.records = []

    def append(self, record):
        self.records.append(record)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fluid", "twin"])
def test_graph_driver_matches_reference_with_health_on_the_card(
        cuda_device, monkeypatch, backend):
    """The health slice with the gate (A=8, P=2, ``fl_every=1``, eight
    episodes): the graph driver takes the reference driver's actions; its
    histories, final state (health included), launch counts and streamed
    records are the reference's bit for bit; every record equals its
    history row."""
    from repro_torch.core import fleet as tfleet
    cfg = FCPOConfig(fl_every=1)
    a, n_eps = 8, 8
    traces = torch.tensor(np.random.default_rng(5).uniform(
        5.0, 160.0, (a, n_eps * cfg.n_steps)).astype(np.float32),
        device=cuda_device)
    runs = []
    for drive in (tfleet.train_fleet_reference, tfleet.train_fleet_scan):
        rec = recorded_actions(monkeypatch, n_eps * cfg.n_steps, a,
                               cuda_device)
        fleet = tfleet.fleet_init(cfg, a, 11, n_pods=2, device=cuda_device,
                                  env_backend=backend)
        diversity_insert.launches = delta_codec.launches = 0
        queue_advance.launches = 0
        sink = ListSink()
        fleet, hist = drive(cfg, fleet, traces, straggler_prob=0.25, seed=3,
                            env_backend=backend, metrics_sink=sink,
                            **health_kwargs())
        runs.append((rec.cpu(), hist, tfleet.fleet_to_numpy(fleet),
                     (diversity_insert.launches, delta_codec.launches,
                      queue_advance.launches), sink.records))
    (act_r, hist_r, state_r, n_r, rec_r), (act_s, hist_s, state_s, n_s,
                                           rec_s) = runs
    assert (act_r >= 0).all() and torch.equal(act_s, act_r)
    for k, v in hist_r.items():
        np.testing.assert_array_equal(hist_s[k], v, err_msg=k)
    assert_trees_equal(state_s, state_r)
    assert "health" in state_s
    assert n_s == n_r == (n_eps, n_eps,
                          n_eps * cfg.n_steps if backend == "twin" else 0)
    assert rec_s == rec_r and len(rec_s) == n_eps
    for i, r in enumerate(rec_s):
        assert r["episode"] == i
        for k, v in hist_s.items():
            assert np.float32(r[k]) == v[i], k


@pytest.mark.cuda
def test_sink_ring_full_keeps_every_record_in_order(cuda_device,
                                                    monkeypatch):
    """The graph driver's stream with a ring of two pinned slots (the
    host runs ahead of the device and waits for its oldest copy): twelve
    episodes give twelve records, in order, each exactly once, equal to
    the history rows and to the records of the default ring."""
    from repro_torch.core import fleet as tfleet
    cfg = FCPOConfig()
    traces = torch.tensor(np.random.default_rng(6).uniform(
        5.0, 160.0, (8, 12 * cfg.n_steps)).astype(np.float32),
        device=cuda_device)
    runs = []
    for depth in (2, tfleet.SINK_DEPTH):
        monkeypatch.setattr(tfleet, "SINK_DEPTH", depth)
        sink = ListSink()
        driver = tfleet.FleetScan(
            cfg, tfleet.fleet_init(cfg, 8, 0, n_pods=2, device=cuda_device),
            traces, metrics_sink=sink, **health_kwargs())
        _, hist = driver.run()
        runs.append((sink.records, hist, driver.tap.waits))
    (rec, hist, waits), (rec_default, _, _) = runs
    assert waits > 0
    assert [r["episode"] for r in rec] == list(range(12))
    for i, r in enumerate(rec):
        for k, v in hist.items():
            assert np.float32(r[k]) == v[i], k
    assert rec == rec_default


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fluid", "twin"])
def test_health_card_run_matches_cpu_run(cuda_device, backend):
    """The health slice from one numpy fleet state with one set of action
    noise, on the card and on the CPU: histories within rtol 1e-3 / atol
    1e-4, the health state's counts (histograms, observations, marker
    positions) identical while the actions agree."""
    from repro_torch.core import fleet as tfleet
    cfg = FCPOConfig(fl_every=1)
    a, n_eps = 4, 8
    tree = tfleet.fleet_to_numpy(tfleet.fleet_init(
        cfg, a, 7, n_pods=2, device="cpu", env_backend=backend))
    rng = np.random.default_rng(7)
    traces = rng.uniform(5.0, 120.0, (a, n_eps * cfg.n_steps)).astype(
        np.float32)
    gumbel = (-np.log(-np.log(rng.uniform(
        1e-6, 1.0, (n_eps, a, cfg.n_steps, 15))))).astype(np.float32)
    out = []
    for dev in (cuda_device, "cpu"):
        fleet = tfleet.fleet_from_numpy(cfg, tree, device=dev)
        fleet, hist = tfleet.train_fleet_scan(
            cfg, fleet, torch.as_tensor(traces, device=dev),
            gumbel=torch.as_tensor(gumbel, device=dev), env_backend=backend,
            **health_kwargs())
        out.append((hist, tfleet.fleet_to_numpy(fleet)))
    (hist_k, st_k), (hist_c, st_c) = out
    for k, v in hist_c.items():
        np.testing.assert_allclose(hist_k[k], v, rtol=1e-3, atol=1e-4,
                                   err_msg=k)
    if np.array_equal(st_k["buffer"]["actions"], st_c["buffer"]["actions"]):
        for k in ("reward_hist", "miss_hist", "n_obs", "sel_last"):
            np.testing.assert_array_equal(st_k["health"][k],
                                          st_c["health"][k], err_msg=k)
        np.testing.assert_array_equal(st_k["health"]["reward_p2"]["n"],
                                      st_c["health"]["reward_p2"]["n"])


# ---------------------------------------------------------------------------
# The flight recorder: span stamps, the recording K3, traced graph runs
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("every,base,delta", [(1, 0, 0), (2, 0, -1),
                                              (3, 5, 0)])
def test_span_stamp_writes_the_plain_versions_slots(cuda_device, every, base,
                                                    delta):
    from repro_torch.kernels.span_stamp import span_stamp, span_stamp_ref
    i64 = dict(dtype=torch.int64, device=cuda_device)
    got, want = torch.zeros((8, 2), **i64), torch.zeros((8, 2), **i64)
    period, clock = torch.tensor(every, **i64), torch.ones((), **i64)
    before = span_stamp.launches
    for e in range(20):
        ep = torch.tensor(e, **i64)
        span_stamp(got, ep, period, 0, delta=delta, base=base)
        span_stamp_ref(want, ep, period, 0, delta=delta, base=base,
                       clock=clock)
    torch.cuda.synchronize()
    assert span_stamp.launches - before == 20
    assert torch.equal(got != 0, want != 0)
    vals = got[:, 0][got[:, 0] != 0]
    assert bool((vals.diff() > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("a", [8, 2048])
def test_recording_k3_matches_plain_on_the_card(cuda_device, a):
    from repro_torch.sim.state import SimParams, sim_init
    sp = SimParams()
    g = torch.Generator(device=cuda_device).manual_seed(a)
    st = sim_init(sp, a, cuda_device).tensors()
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(a, generator=g,
                                                   device=cuda_device)
    for _ in range(8):
        arrivals = torch.randint(0, 6, (a, sp.k_ticks), generator=g,
                                 device=cuda_device, dtype=torch.int32)
        caps = torch.stack([u(0.2, 4.0), u(0.2, 4.0), u(1, 7).floor(),
                            u(1, 7).floor(), u(2, 13).floor(),
                            u(1, 15).floor()], 1)
        rec_k = queue_advance(*st, arrivals, caps, record=True)
        rec_p = queue_advance_ref(*st, arrivals, caps, record=True)
        plain_k = queue_advance(*st, arrivals, caps)
        torch.cuda.synchronize()
        for x, y in zip(rec_k, rec_p):
            assert torch.equal(x, y)
        for x, y in zip(plain_k, rec_k):
            assert torch.equal(x, y)
        st = plain_k


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fluid", "twin"])
def test_traced_graph_run_is_the_untraced_run(cuda_device, backend):
    """The graph driver traced (stamp nodes in its graphs) and untraced:
    the same history bit for bit at sampling 1 and 2; the same stamp
    launches at either sampling; the spans of the sampled episodes."""
    from collections import Counter
    from repro_torch.core.fleet import fleet_init, train_fleet_scan
    from repro_torch.fl.transport import TransportConfig
    from repro_torch.kernels.span_stamp import span_stamp
    from repro_torch.obs.trace import Tracer, validate_chrome_trace
    cfg = FCPOConfig(fl_every=1)
    traces = torch.as_tensor(np.random.default_rng(0).uniform(
        10, 50, (8, 6 * cfg.n_steps)).astype(np.float32), device=cuda_device)
    runs, launches = [], []
    for every in (None, 1, 2):
        tr = None if every is None else Tracer(span_sample_every=every)
        before = span_stamp.launches
        _, hist = train_fleet_scan(
            cfg, fleet_init(cfg, 8, 0, n_pods=2, device=cuda_device,
                            env_backend=backend), traces,
            env_backend=backend, transport=TransportConfig(codec="int8"),
            tracer=tr)
        launches.append(span_stamp.launches - before)
        runs.append(hist)
        if tr is not None:
            trace = tr.chrome_trace()
            assert validate_chrome_trace(trace) == []
            counts = Counter(e["name"] for e in trace["traceEvents"]
                             if e["ph"] == "X")
            assert counts["episode"] == 6 // every
            assert counts["kernel/delta_codec"] == counts["fl/encode"] == \
                6 // every
    for hist in runs[1:]:
        for k, v in runs[0].items():
            np.testing.assert_array_equal(hist[k], v, err_msg=k)
    assert launches[0] == 0 and launches[1] == launches[2] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("every", [1, 2])
def test_top_level_kernel_span_on_the_card(cuda_device, every):
    """Under an active ``kernel_spans`` tracer every kernel called at the
    top level gets its own span, named after it, whatever the tracer's
    episode sampling; the results are the untraced calls'."""
    from repro_torch.kernels.packing import pack
    from repro_torch.obs.trace import Tracer, activate
    tok = torch.randn((64, 128), device=cuda_device)
    idx = torch.tensor([0, 63, -1, 5, 5, -1, 17, 2], dtype=torch.int32,
                       device=cuda_device)
    d = torch.randn((4, 96), device=cuda_device)
    r = torch.zeros_like(d)
    base = pack(tok, idx), delta_codec(d, r, codec="int8")
    with Tracer(span_sample_every=every, kernel_spans=True) as tr, \
            activate(tr):
        out = [(pack(tok, idx), delta_codec(d, r, codec="int8"))
               for _ in range(3)]
    ev = tr.chrome_events()
    assert [e["name"] for e in ev] == \
        ["kernel/pack", "kernel/delta_codec"] * 3
    assert all(e["ph"] == "X" and e["cat"] == "kernel" for e in ev)
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(ev, ev[1:]))
    for o in out:
        assert torch.equal(o[0], base[0])
        assert all(torch.equal(x, y) for x, y in zip(o[1], base[1]))


# ---------------------------------------------------------------------------
# the paper's comparison set
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("a", [2, 64])
@pytest.mark.parametrize("fill", [0, 350, 800])
def test_k1_at_the_bcedge_shape_matches_plain(cuda_device, a, fill):
    """N=700 slots, NA=13 (BCEdge's offline buffers): ~62 KB of shared
    memory a block, the opt-in path above 48 KB."""
    rng = np.random.default_rng(a + fill)
    assert_k1_matches(k1_inputs(rng, a, fill, 10, n=700, n_mt=2),
                      cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fluid", "twin"])
def test_single_head_graph_driver_matches_reference(cuda_device, backend):
    """The Fig. 12 single head: the graph driver == the reference driver
    bit for bit (histories, every state leaf), K1 once per episode, K2
    once per round over its 8 leaves, K3 once per twin interval."""
    from repro_torch.core.fleet import (fleet_init, fleet_to_numpy,
                                        train_fleet_reference,
                                        train_fleet_scan)
    from repro_torch.fl.transport import TransportConfig
    cfg = FCPOConfig(single_head=True, fl_every=1)
    traces = torch.as_tensor(np.random.default_rng(1).uniform(
        5, 160, (8, 6 * cfg.n_steps)).astype(np.float32), device=cuda_device)
    runs = []
    for drive in (train_fleet_reference, train_fleet_scan):
        counts = (diversity_insert.launches, delta_codec.launches,
                  queue_advance.launches)
        fleet, hist = drive(cfg, fleet_init(cfg, 8, 3, n_pods=2,
                                            device=cuda_device,
                                            env_backend=backend),
                            traces, env_backend=backend, straggler_prob=0.25,
                            seed=2, transport=TransportConfig(codec="int8"))
        counts = tuple(x.launches - c for x, c in zip(
            (diversity_insert, delta_codec, queue_advance), counts))
        assert counts == (6, 6, 60 if backend == "twin" else 0)
        runs.append((hist, fleet_to_numpy(fleet)))
    (h_r, st_r), (h_s, st_s) = runs
    for k, v in h_r.items():
        np.testing.assert_array_equal(h_s[k], v, err_msg=k)
    assert set(st_r["params"]) == {"backbone", "value", "head_res"}

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", np.asarray(v)
    got = dict(flat(st_s))
    for k, v in flat(st_r):
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.cuda
def test_sim_interval_agent_matches_plain_and_the_oracle(cuda_device):
    """One agent's twin through K3 at A=1 (one launch an interval) == the
    plain advance on the card bit for bit == ``sim/oracle.py`` request for
    request."""
    from repro_torch.sim import oracle
    from repro_torch.sim.state import SimParams, SimState, sim_init
    from repro_torch.sim.step import sim_interval_agent, sim_interval_ref
    sp = SimParams(dt=0.05, k_ticks=8, ring=32, hist_n=16)
    rng = np.random.default_rng(4)
    t_int = 20
    arrivals = rng.integers(0, 7, (t_int, sp.k_ticks)).astype(np.int32)
    caps = np.stack([rng.choice([1.5, 2.0, 2.5, 3.0], t_int),
                     rng.choice([2.0, 3.0, 4.0], t_int),
                     rng.choice([2.0, 4.0, 8.0], t_int),
                     rng.choice([1.0, 2.0, 3.0], t_int),
                     np.full(t_int, 8.0), np.full(t_int, 5.0)],
                    1).astype(np.float32)
    st_k = st_p = SimState(*(x[0] for x in sim_init(
        sp, 1, cuda_device).tensors()))
    before = queue_advance.launches
    for t in range(t_int):
        args = (torch.as_tensor(arrivals[t], device=cuda_device),
                torch.as_tensor(caps[t], device=cuda_device))
        st_k = sim_interval_agent(st_k, *args)
        st_p = sim_interval_ref(st_p, *args)
        for x, y in zip(st_k.tensors(), st_p.tensors()):
            assert torch.equal(x, y)
    assert queue_advance.launches == before + t_int
    py = oracle.simulate_python_agent(arrivals, caps, sp)
    assert (int(st_k.arrived), int(st_k.dropped), int(st_k.completed),
            int(st_k.effective), float(st_k.lat_sum),
            int(st_k.in_flight)) == tuple(py[k] for k in (
                "arrived", "dropped", "completed", "effective", "lat_sum",
                "in_flight"))


@pytest.mark.cuda
def test_buffer_insert_on_the_card_matches_the_cpu(cuda_device):
    """``buffer_insert`` (K1 at T=1, one launch a call) chained 40 times
    on the card against the same calls on the CPU (plain version):
    identical slots and counts, floats within rtol 1e-4 / atol 1e-5."""
    from repro_torch.core.buffer import buffer_insert
    cfg = FCPOConfig(buffer_size=16)
    rng = np.random.default_rng(5)
    bufs = {d: buffer_init(cfg, 8, d) for d in ("cpu", cuda_device)}
    before = diversity_insert.launches
    for _ in range(40):
        s = rng.normal(size=(8, 8)) * 3.0
        p = rng.dirichlet(np.ones(15), size=8)
        pay = (rng.integers(0, 4, (8, 3)), rng.normal(size=8),
               rng.normal(size=8), rng.normal(size=8))
        for d in bufs:
            f = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt,
                                                            device=d)
            bufs[d] = buffer_insert(cfg, bufs[d], f(s), f(pay[0], torch.long),
                                    f(pay[1]), f(pay[2]), f(pay[3]), f(p))
    assert diversity_insert.launches == before + 40
    cpu, card = bufs["cpu"], bufs[cuda_device]
    for name in ("filled", "n_filled", "count", "actions"):
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
    for name in ("states", "probs", "score", "s_sum", "s_outer", "p_sum",
                 "logp", "rewards", "values"):
        torch.testing.assert_close(getattr(card, name).cpu(),
                                   getattr(cpu, name), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["fluid", "twin"])
def test_static_baselines_on_the_card_match_the_cpu(cuda_device, backend):
    """OctopInf and Distream at n=8: the card's episode histories within
    rtol 1e-3 / atol 1e-4 of the CPU's; K3 once per twin interval."""
    from repro_torch.core.baselines import run_distream, run_octopinf
    traces = np.random.default_rng(6).uniform(5, 160, (8, 30)).astype(
        np.float32)
    for run in (lambda d: run_octopinf(8, traces, period=10,
                                       env_backend=backend, device=d),
                lambda d: run_distream(8, traces, env_backend=backend,
                                       device=d)):
        before = queue_advance.launches
        card = run(cuda_device)
        assert queue_advance.launches - before == (30 if backend == "twin"
                                                   else 0)
        for k, v in run("cpu").items():
            np.testing.assert_allclose(card[k], v, rtol=1e-3, atol=1e-4,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# The fleet mesh on the card
# ---------------------------------------------------------------------------
def _fleet_leaves(fleet):
    """The whole fleet's leaves as {name: numpy}, bf16 as raw bits."""
    from repro_torch.core.fleet import fleet_gather, fleet_to_numpy

    def walk(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}.")
            else:
                v = np.asarray(v)
                yield f"{prefix}{k}", v.view(np.uint16) \
                    if v.dtype.kind == "V" else v
    return dict(walk(fleet_to_numpy(fleet_gather(fleet))))


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], ["--env-backend", "twin"],
                                   ["--fl-codec", "int8"]],
                         ids=["fluid", "twin", "int8"])
def test_one_nccl_rank_graph_run_is_meshless_bit_for_bit(cuda_device,
                                                         extra):
    """``train_fleet --mesh fleet`` on one NCCL rank under the graph
    driver (the collectives captured in the graphs) equals ``--mesh
    none`` bit for bit: histories, every leaf of the final fleet, K1–K3
    launches."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import COLLECTIVES
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train_fleet
    owns = mesh_mod.init_world("cuda")
    try:
        runs = []
        for mesh in ("none", "fleet"):
            diversity_insert.launches = delta_codec.launches = 0
            queue_advance.launches = COLLECTIVES.launches = 0
            fleet, hist = train_fleet.main(
                ["--episodes", "6", "--fl-every", "1", "--mesh", mesh,
                 *extra])
            runs.append((hist, _fleet_leaves(fleet),
                         (diversity_insert.launches, delta_codec.launches,
                          queue_advance.launches), COLLECTIVES.launches))
        (h0, s0, k0, c0), (h1, s1, k1, c1) = runs
        assert k0 == k1 and c0 == 0 and c1 > 0
        for k, v in h0.items():
            np.testing.assert_array_equal(h1[k], v, err_msg=k)
        for k, v in s0.items():
            np.testing.assert_array_equal(s1[k], v, err_msg=k)
    finally:
        if owns:
            dist.destroy_process_group()


def _spawn_mesh_ranks(tmp_path, world, name, backend, driver):
    """``world`` ranks of ``tests/torch_mesh_rank.py`` running one library
    scenario on the card: A=8, P=2, ``fl_every`` 1, stragglers 0.3, eight
    episodes, under ``driver`` on a ``backend`` world (gloo ranks share
    card 0, NCCL rank r takes card r). Each rank is killed at 240 s.
    Returns (cfg, the whole fleet's numpy tree, the traces)."""
    import json
    from repro_torch.core.fleet import fleet_init, fleet_to_numpy
    cfg = FCPOConfig(fl_every=1)
    tree = fleet_to_numpy(fleet_init(cfg, 8, 0, n_pods=2, device="cpu"))
    traces = np.random.default_rng(9).uniform(
        5.0, 160.0, (8, 8 * cfg.n_steps)).astype(np.float32)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"fleet/{prefix}{k}"] = np.asarray(v)
    walk(tree, "")
    np.savez(tmp_path / "lib.npz", traces=traces, **flat)
    spec = {"out": str(tmp_path), "device": "cuda", "backend": backend,
            "scenarios": [{"name": name, "lib": {
                "npz": str(tmp_path / "lib.npz"), "driver": driver,
                "straggler_prob": 0.3, "seed": 3}}]}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(root / "tests" / "torch_mesh_rank.py"), str(r),
         str(world), str(tmp_path / "rendezvous"),
         str(tmp_path / "spec.json")], env=env) for r in range(world)]
    try:
        for p in procs:
            p.wait(timeout=240)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * world
    return cfg, tree, traces


def _meshed_matches(out, fleet, hist, world):
    """A meshed run saved in ``out`` against the meshless ``fleet`` and
    ``hist``: within rtol/atol 1e-5, integer state exact; ``world``
    balanced ``fleet_device_bytes`` entries. Returns rank 0's info."""
    import json
    from repro_torch.training import checkpoint as ckpt
    with np.load(out / "hist.npz") as got:
        for k, v in hist.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    _, data = ckpt.load(str(out), 0)
    for k, v in ckpt.fleet_flat(fleet).items():
        if k.startswith("torch/"):
            continue
        if v.dtype.kind == "f":
            np.testing.assert_allclose(data[k], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(data[k], v, err_msg=k)
    info = json.loads((out / "info.json").read_text())
    per = sorted(info["device_bytes"].values())
    assert len(per) == world and per[-1] <= 2 * per[0]
    return info


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_match_meshless(cuda_device, tmp_path):
    """Two gloo ranks share the card (``tests/torch_mesh_rank.py``, CUDA
    tensors, the reference driver; the graph driver refuses a gloo mesh on
    the card): A=8, P=2, stragglers 0.3, eight episodes equal the meshless
    card run within rtol/atol 1e-5, integer state exact; two balanced
    ``fleet_device_bytes`` entries."""
    from repro_torch.core.fleet import fleet_from_numpy, train_fleet_reference
    cfg, tree, traces = _spawn_mesh_ranks(tmp_path, 2, "gloo", "gloo",
                                          "reference")
    fleet, hist = train_fleet_reference(
        cfg, fleet_from_numpy(cfg, tree, device=cuda_device),
        torch.tensor(traces), straggler_prob=0.3, seed=3)
    info = _meshed_matches(tmp_path / "gloo", fleet, hist, 2)
    assert info["k1"] == 8 and info["agents"] == [0, 4]


@pytest.mark.cuda
def test_nccl_ranks_on_several_cards_capture_the_mesh(cuda_device,
                                                      tmp_path):
    """NCCL ranks, one card each, under the graph driver: every rank's
    graphs hold its collectives, and the run equals the meshless graph run
    on one card within rtol/atol 1e-5, integer state exact. Four cards
    make a (pod 2, data 2) mesh whose pod group (two ranks) is not the
    world, each group warmed before the first capture; two cards make
    (pod 2, data 1)."""
    from repro_torch.core.fleet import fleet_from_numpy, train_fleet_scan
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    world = 4 if n >= 4 else 2
    cfg, tree, traces = _spawn_mesh_ranks(tmp_path, world, "nccl", "nccl",
                                          "scan")
    fleet, hist = train_fleet_scan(
        cfg, fleet_from_numpy(cfg, tree, device=cuda_device),
        torch.tensor(traces), straggler_prob=0.3, seed=3)
    info = _meshed_matches(tmp_path / "nccl", fleet, hist, world)
    assert info["agents"] == [0, 8 // world]
    assert info["k1"] == 8 and info["graph_launches"] > 0
    assert info["collectives"] > 0
    assert info["pod_group_is_world"] == (world == 2)
    assert info["warmed"] == ([world, 2] if world == 4 else [world])


# ---------------------------------------------------------------------------
# The transformer family: MoE and MLA on the card
# ---------------------------------------------------------------------------
MOE_ARCHS = ["deepseek-v2-lite-16b", "granite-moe-3b-a800m"]


def _reduced_pair(name, device):
    """A reduced float32 model with the same CPU-made parameters on the
    CPU and on ``device``."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.registry import (get_model, params_from_numpy,
                                             params_to_numpy)
    cfg = get_config(name).reduced()
    model = get_model(cfg)
    tree = params_to_numpy(model.init(torch.Generator().manual_seed(0)))
    return model, params_from_numpy(cfg, tree, "cpu"), \
        params_from_numpy(cfg, tree, device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_reduced_moe_model_on_the_card_matches_the_cpu(cuda_device, name):
    """Logits within rtol 1e-3 / atol 1e-4 (as the reduced LM's card vs CPU
    check), the MoE aux loss too, and the first MoE layer's routing (top-k
    ids, ``keep``, slots) equal on the same input."""
    from repro_torch.models import moe
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import _layer
    model, p_cpu, p_card = _reduced_pair(name, cuda_device)
    cfg = model.cfg
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)), dtype=torch.int32)
    want, _, want_aux = model.apply(p_cpu, {"tokens": tok})
    got, _, aux = model.apply(p_card, {"tokens": tok.to(cuda_device)})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(aux["moe_aux"].cpu(), want_aux["moe_aux"],
                               rtol=1e-4, atol=1e-6)
    layer = _layer(p_cpu["blocks"], 0)
    h = rmsnorm(layer["ln2"], torch.randn(
        64, cfg.d_model, generator=torch.Generator().manual_seed(1)))
    r_cpu = moe.moe_route(layer["moe"], cfg, h)
    r_card = moe.moe_route(_layer(p_card["blocks"], 0)["moe"], cfg,
                           h.to(cuda_device))
    for key in ("topi", "order", "keep", "slot"):
        assert torch.equal(getattr(r_card, key).cpu(), getattr(r_cpu, key)), \
            key


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_reduced_moe_cache_path_on_the_card_matches_the_cpu(cuda_device,
                                                            name):
    """A prefill of 12 tokens into a float32 cache, then four one-token
    steps (deepseek: MLA's absorbed path against the compressed cache;
    granite: K5 on the card, its plain version on the CPU): logits within
    rtol 1e-3 / atol 1e-4 at every step, the caches too."""
    model, p_cpu, p_card = _reduced_pair(name, cuda_device)
    rng = np.random.default_rng(3)
    caches = [model.new_cache(2, 32, torch.float32, dev)
              for dev in ("cpu", cuda_device)]
    for step in range(5):
        tok = torch.as_tensor(rng.integers(0, model.cfg.vocab_size, (
            2, 12 if step == 0 else 1)), dtype=torch.int32)
        want, caches[0], _ = model.apply(p_cpu, {"tokens": tok}, caches[0])
        got, caches[1], _ = model.apply(p_card, {"tokens": tok.to(
            cuda_device)}, caches[1])
        torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-4)
    for key in caches[0]:
        if key not in ("first", "offset"):
            torch.testing.assert_close(caches[1][key].cpu(), caches[0][key],
                                       rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
def test_moe_combine_on_the_card_is_repeatable_and_the_cpus(cuda_device):
    """The deterministic combine: bf16, two calls equal bit for bit, and
    equal to the CPU's combine of the same contributions; the whole bf16
    MoE layer equal to itself across calls."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe
    from repro_torch.models.transformer import _layer
    rng = np.random.default_rng(2)
    t_, k, d = 512, 6, 2048
    topi = np.stack([rng.permutation(64)[:k] for _ in range(t_)])
    order = torch.as_tensor(np.argsort(topi.reshape(-1), kind="stable"))
    contrib = torch.as_tensor(rng.normal(size=(t_ * k, d)),
                              dtype=torch.bfloat16)
    a = moe.combine(contrib.to(cuda_device), order.to(cuda_device), k)
    b = moe.combine(contrib.to(cuda_device), order.to(cuda_device), k)
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), moe.combine(contrib, order, k))
    cfg = get_config("deepseek-v2-lite-16b").reduced().replace(
        dtype="bfloat16")
    _, _, p_card = _reduced_pair("deepseek-v2-lite-16b", cuda_device)
    x = torch.randn(4, 32, cfg.d_model, device=cuda_device,
                    dtype=torch.bfloat16)
    layer = _layer(p_card["blocks"], 0)["moe"]
    first = moe.moe_apply(layer, cfg, x)
    again = moe.moe_apply(layer, cfg, x)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_serve_launcher_on_a_reduced_moe_config_launches(cuda_device, name):
    """``serve --arch <moe> --reduced`` on the card: K1 once per episode;
    K5 once per layer per decode step in granite (GQA), never in deepseek
    (MLA runs no kernel, as in the reference); K2, K3, K4, K6 never."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.packing import pack
    from repro_torch.launch import serve
    fns = (diversity_insert, delta_codec, queue_advance, flash_attention,
           decode_attention, pack)
    for fn in fns:
        fn.launches = 0
    summ = serve.main(["--arch", name, "--reduced", "--replicas", "2",
                       "--episodes", "3"])
    n_layers = get_config(name).reduced().n_layers
    want = [3, 0, 0, 0, 0 if name.startswith("deepseek") else 3 * n_layers,
            0]
    assert [fn.launches for fn in fns] == want
    for key in ("reward", "effective_throughput", "latency", "generate_s"):
        assert np.isfinite(summ[key]).all()
