"""The port's attention and packing kernels' plain versions against the JAX
package (``repro.kernels``), on the CPU, from the same numpy inputs.

K4 ``flash_attention`` and K5 ``decode_attention`` take their plain
versions for CPU tensors; they are held against the JAX oracles
``repro.kernels.ref.flash_attention_ref`` / ``decode_attention_ref`` (the
Pallas flash and decode kernels do not run in interpret mode on this
host's jax) on the JAX tests' sweep, at the JAX tests' tolerances:
rtol = atol = 2e-5 in float32, 2e-2 in bf16. So are the plain forms of the
CUDA kernels' own arithmetic: K5's split-KV partials and combine, and K4's
bf16 path (P rounded to bf16 before P V). K6 ``pack`` is held bit for bit
against the Pallas ``pack`` in interpret mode, which runs here.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.packing import pack as j_pack
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (MAX_SPLITS, SPLIT_ALIGN,
                                                  decode_attention,
                                                  num_splits, split_bounds)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.packing import pack
from repro_torch.kernels.ref import (decode_attention_ref,
                                     decode_attention_split_ref,
                                     flash_attention_bf16p_ref,
                                     flash_attention_ref, pack_ref)

# (b, sq, sk, hq, hkv, d, dtype, causal): tests/test_kernels.py FLASH_CASES
FLASH_CASES = [
    (2, 128, 128, 4, 4, 64, "float32", True),
    (2, 128, 128, 4, 2, 64, "float32", True),
    (1, 256, 256, 8, 1, 64, "float32", True),
    (1, 128, 128, 4, 4, 128, "bfloat16", True),
    (1, 128, 128, 2, 2, 256, "float32", True),
    (2, 128, 128, 4, 4, 80, "float32", False),
    (1, 384, 384, 7, 1, 64, "float32", True),
    # ragged and reduced-config shapes of the port's model path
    (2, 16, 16, 4, 2, 32, "float32", True),
    (1, 50, 70, 4, 2, 32, "float32", False),
]
# (b, hq, hkv, d, s_max, kv_len, dtype): tests/test_kernels.py DECODE_CASES
DECODE_CASES = [
    (2, 4, 4, 64, 256, 256, "float32"),
    (2, 4, 2, 64, 512, 300, "float32"),
    (1, 8, 2, 128, 512, 77, "float32"),
    (1, 14, 2, 64, 512, 500, "float32"),
    (1, 4, 4, 128, 256, 128, "bfloat16"),
    (2, 16, 16, 256, 256, 199, "float32"),
    (3, 4, 2, 32, 48, 17, "float32"),       # the reduced serve path
]
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype`` (bf16
    rounded once, by numpy, for both)."""
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
        return jnp.asarray(x), torch.from_numpy(x.astype(np.float32)).to(
            torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol(dtype), atol=tol(dtype))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_jax_oracle(case):
    b, sq, sk, hq, hkv, d, dtype, causal = case
    rng = np.random.default_rng(sum(case[:6]))
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.normal(size=s).astype(np.float32), dtype)
        for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    before = flash_attention.launches
    got = flash_attention(qt, kt, vt, causal=causal)
    assert flash_attention.launches == before       # CPU: plain version
    assert got.dtype == TORCH[dtype] and got.shape == (b, sq, hq, d)
    close(got, jref.flash_attention_ref(qj, kj, vj, causal=causal), dtype)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_plain_matches_jax_oracle(case):
    b, hq, hkv, d, s_max, kv_len, dtype = case
    rng = np.random.default_rng(sum(case[:6]))
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.normal(size=s).astype(np.float32), dtype)
        for s in ((b, 1, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d)))
    before = decode_attention.launches
    got = decode_attention(qt, kt, vt, kv_len)
    assert decode_attention.launches == before
    assert got.dtype == TORCH[dtype] and got.shape == (b, 1, hq, d)
    close(got, jref.decode_attention_ref(qj, kj, vj, kv_len), dtype)


def test_decode_attention_mixed_cache_type_matches_jax_oracle():
    """float32 queries over a bf16 cache (the reduced engine's default)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 1, 4, 32)).astype(np.float32)
    qj, qt = both(q, "float32")
    (kj, kt), (vj, vt) = (both(rng.normal(size=(2, 64, 2, 32)).astype(
        np.float32), "bfloat16") for _ in range(2))
    got = decode_attention(qt, kt, vt, 40)
    assert got.dtype == torch.float32
    close(got, jref.decode_attention_ref(qj, kj, vj, 40), "float32")


def test_decode_attention_ignores_invalid_tail():
    """Garbage beyond kv_len must not affect the result (the kernel never
    reads it), as tests/test_kernels.py asks of the Pallas kernel."""
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(1, 1, 4, 64)), dtype=torch.float32)
    kc = torch.tensor(rng.normal(size=(1, 512, 4, 64)), dtype=torch.float32)
    vc = torch.tensor(rng.normal(size=(1, 512, 4, 64)), dtype=torch.float32)
    out1 = decode_attention(q, kc, vc, 200)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, 200:] = 1e9
    vc2[:, 200:] = -1e9
    out2 = decode_attention(q, kc2, vc2, 200)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-6)
    want = jref.decode_attention_ref(*(jnp.asarray(x.numpy()) for x in
                                       (q, kc2, vc2)), 200)
    close(out2, want, "float32")


def test_decode_plain_with_per_row_lengths_matches_jax_oracle():
    """The plain version also takes a (B,) kv_len, as the oracle does."""
    rng = np.random.default_rng(3)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((3, 1, 4, 32), (3, 64, 2, 32), (3, 64, 2, 32))]
    lens = np.array([1, 33, 64], np.int32)
    got = decode_attention_ref(*(torch.from_numpy(a) for a in arrs),
                               torch.from_numpy(lens))
    close(got, jref.decode_attention_ref(*(jnp.asarray(a) for a in arrs),
                                         jnp.asarray(lens)), "float32")


def test_flash_decode_agree_on_the_last_row():
    """Causal flash attention's last query row is decode attention over the
    whole sequence (two plain versions, one function)."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
               for s in ((2, 40, 14, 64), (2, 40, 2, 64), (2, 40, 2, 64)))
    full = flash_attention_ref(q, k, v, causal=True)
    last = decode_attention_ref(q[:, -1:].contiguous(), k, v, 40)
    torch.testing.assert_close(full[:, -1:], last, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_pack_plain_bit_identical_to_pallas_interpret(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(64, 128)) * 10).astype(np.float32)
    if dtype == "int32":
        tok_j, tok_t = jnp.asarray(x.astype(np.int32)), torch.from_numpy(
            x.astype(np.int32))
    else:
        tok_j, tok_t = both(x, dtype)
    idx = np.array([0, 63, -1, 5, 5, -1, 17, 2], np.int32)
    before = pack.launches
    got = pack(tok_t, torch.from_numpy(idx))
    assert pack.launches == before
    want = np.asarray(j_pack(tok_j, jnp.asarray(idx), interpret=True))
    assert got.dtype == tok_t.dtype and got.shape == (8, 128)
    if dtype == "bfloat16":
        got, want = got.float(), want.astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[2].any() and not got[5].any()


# (T, D, dtype, indices): rows of 3 float32 (12 bytes: K6's 4-byte words on
# the card) and 3 bf16 (6 bytes: its 1-byte words), and one row (N=1)
PACK_NARROW = {
    "float32_rows_of_3": (40, 3, "float32", [0, 39, -1, 7, 7, -3, 12, 45]),
    "bfloat16_rows_of_3": (40, 3, "bfloat16", [5, -1, 39, 0, 41, 5, -2]),
    "n1": (16, 128, "float32", [9]),
    "n1_padding": (16, 128, "bfloat16", [-1]),
}


@pytest.mark.pallas
@pytest.mark.parametrize("name", sorted(PACK_NARROW))
def test_pack_plain_bit_identical_to_pallas_interpret_narrow(name):
    """K6's plain version == the Pallas ``pack`` (interpret mode) bit for bit
    on the row sizes that take the card's narrower word paths, and on one
    output row."""
    t, d, dtype, idx = PACK_NARROW[name]
    rng = np.random.default_rng(len(name))
    tok_j, tok_t = both((rng.normal(size=(t, d)) * 10).astype(np.float32),
                        dtype)
    idx = np.array(idx, np.int32)
    got = pack(tok_t, torch.from_numpy(idx))
    want = np.asarray(j_pack(tok_j, jnp.asarray(idx), interpret=True))
    assert got.dtype == tok_t.dtype and got.shape == (len(idx), d)
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    np.testing.assert_array_equal(
        got.view(torch.int16 if dtype == "bfloat16" else torch.int32)
        .numpy().view(bits), want.view(bits))
    assert not got[torch.from_numpy(idx) < 0].any()


def test_pack_plain_clips_like_the_jax_oracle():
    """An index past T - 1 reads row T - 1 and negatives give zero rows,
    bit for bit as ``repro.kernels.ref.pack_ref``."""
    rng = np.random.default_rng(1)
    tok = rng.normal(size=(32, 24)).astype(np.float32)
    idx = rng.integers(-8, 40, 200).astype(np.int32)
    got = pack_ref(torch.from_numpy(tok), torch.from_numpy(idx))
    want = np.asarray(jref.pack_ref(jnp.asarray(tok), jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)


# (b, hq, hkv, d, s_max, kv_len, bounds): K5's split-and-combine on key
# ranges that the kernel's rule gives, or that it must survive
SPLIT_CASES = {
    "one_split": (2, 14, 2, 64, 256, 200, [(0, 256)]),
    "many_splits": (2, 4, 2, 64, 512, 300, split_bounds(300, 5)),
    "boundary_at_kv_len": (1, 8, 2, 32, 256, 192, [(0, 128), (128, 192)]),
    "splits_past_kv_len": (2, 4, 4, 80, 256, 100,
                           [(0, 64), (64, 128), (128, 192), (192, 256)]),
    "kv_len_1": (3, 4, 2, 128, 48, 1, split_bounds(1, 3)),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_decode_split_and_combine_matches_plain_and_jax_oracle(name):
    """K5's arithmetic with several splits: partials (m, l, acc) per key
    range, then the combine; a range with no valid key adds exactly 0."""
    b, hq, hkv, d, s_max, kv_len, bounds = SPLIT_CASES[name]
    rng = np.random.default_rng(len(name))
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, 1, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d))]
    q, kc, vc = (torch.from_numpy(a) for a in arrs)
    got = decode_attention_split_ref(q, kc, vc, kv_len, bounds)
    assert got.shape == (b, 1, hq, d) and torch.isfinite(got).all()
    close(got, decode_attention_ref(q, kc, vc, kv_len).numpy(), "float32")
    close(got, jref.decode_attention_ref(*(jnp.asarray(a) for a in arrs),
                                         kv_len), "float32")


@pytest.mark.parametrize("b,hkv,kv_len", [
    (8, 2, 17), (8, 2, 159), (1, 2, 17), (64, 2, 4096), (2, 2, 4096),
    (2, 2, 4097), (64, 2, 1), (1, 1, 32768)])
def test_decode_split_rule(b, hkv, kv_len):
    """One split (no combine) on the serve path's short caches, several at
    the engine's default B=64 / kv_len 4096; the ranges tile [0, kv_len)
    in multiples of 64 keys."""
    n = num_splits(b, hkv, kv_len)
    assert 1 <= n <= MAX_SPLITS
    if kv_len <= 256:
        assert n == 1
    if (b, hkv, kv_len) == (64, 2, 4096):
        assert n > 1
    bounds = split_bounds(kv_len, n)
    assert len(bounds) == n
    assert all(s % SPLIT_ALIGN == 0 for s, _ in bounds)
    assert [k for s, e in bounds for k in range(s, e)] == list(range(kv_len))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_bf16p_emulation_within_band_of_jax_oracle(case):
    """K4's bf16 numerics (P rounded to bf16 before P V) stay inside the
    JAX tests' bf16 band of the oracle on every shape of the sweep."""
    b, sq, sk, hq, hkv, d, _, causal = case
    rng = np.random.default_rng(sum(case[:6]))
    (qj, qt), (kj, kt), (vj, vt) = (
        both(rng.normal(size=s).astype(np.float32), "bfloat16")
        for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    got = flash_attention_bf16p_ref(qt, kt, vt, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, hq, d)
    close(got, jref.flash_attention_ref(qj, kj, vj, causal=causal),
          "bfloat16")


# the flags of the parent tree; K1, K2, K3 and K6 keep them and their hashes
OLD_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
             "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
             "-fPIC")


@pytest.mark.parametrize("name", build.KERNELS)
def test_build_flags_per_kernel(name):
    import hashlib
    flags = build.flags(name)
    if name in ("flash_attention", "decode_attention"):
        assert flags == tuple(f for f in OLD_FLAGS if f != "-fmad=false")
    else:
        assert flags == OLD_FLAGS
        src = (build.CSRC / f"{name}.cu").read_bytes()
        tag = hashlib.sha256(src + " ".join(OLD_FLAGS).encode()).hexdigest()
        assert build.library_path(name).name == f"{name}-{tag[:16]}.so"
    assert "use_fast_math" not in " ".join(flags)
