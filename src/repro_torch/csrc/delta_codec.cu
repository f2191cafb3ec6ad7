// K2 delta_codec: the FL error-feedback encode/decode, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/delta_codec.py:41
// (delta_codec -> _codec_kernel). Plain version:
// repro_torch/kernels/ref.py::delta_codec_ref.
//
// One launch per parameter leaf, one block per agent row of L values, as the
// TPU kernel is called. The block forms xf = delta + residual and then
//   float32: decoded = xf, residual = 0;
//   int8:    a block max-reduce of |xf|, scale = max(m, 1e-12) * (1/127),
//            frac = xf / scale, q = clip(rint(frac), +-127) (half to even),
//            decoded = q * scale, residual = (frac - q) * scale;
//   topk:    keep exactly the k largest |xf| with ties to the lowest index:
//            a 4-pass 8-bit radix select on the uint32 bit pattern of |xf|
//            (monotone for non-negative floats) finds the k-th largest
//            value, then one index-ordered pass takes the first
//            k - #(|xf| > thresh) of the entries equal to it.
//
// Bound: 16 B per value per round (two reads, two writes): 72 KB per agent
// over the 12 leaves of one iAgent, ~148 MB at A=2048, ~44 us of HBM time on
// an H100 (3.35 TB/s). At A=8 the 12 launches per round dominate; fusing the
// leaves into one segmented launch is later work. The topk path re-reads
// the row once per radix pass (from L2 at these sizes).
//
// Numerics: built with -fmad=false and IEEE division, so every result is
// bit-identical to the plain PyTorch version and to the JAX oracle.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
enum Codec { kFloat32 = 0, kInt8 = 1, kTopk = 2 };

// jnp.max / jnp.clip: NaN propagates (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(FULL, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = nan_max(v, __shfl_xor_sync(FULL, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__global__ void __launch_bounds__(THREADS) delta_codec_kernel(
    const float* __restrict__ delta, const float* __restrict__ residual,
    float* __restrict__ dec, float* __restrict__ res, int L, int codec,
    int k) {
  __shared__ float red[WARPS];
  __shared__ unsigned hist[256];
  __shared__ unsigned s_prefix, s_kk, s_warp[WARPS];
  const size_t row = (size_t)blockIdx.x * L;
  const float* dl = delta + row;
  const float* rs = residual + row;
  float* o_dec = dec + row;
  float* o_res = res + row;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (codec == kFloat32 || (codec == kTopk && k >= L)) {
    for (int i = tid; i < L; i += THREADS) {
      o_dec[i] = dl[i] + rs[i];
      o_res[i] = 0.0f;
    }
    return;
  }

  if (codec == kInt8) {
    float m = -INFINITY;
    for (int i = tid; i < L; i += THREADS) m = nan_max(m, fabsf(dl[i] + rs[i]));
    m = block_max(m, red);
    const float scale = nan_max(m, 1e-12f) * (1.0f / 127.0f);
    for (int i = tid; i < L; i += THREADS) {
      const float frac = (dl[i] + rs[i]) / scale;
      float q = rintf(frac);
      q = (q != q) ? q : fminf(fmaxf(q, -127.0f), 127.0f);
      o_dec[i] = q * scale;
      o_res[i] = (frac - q) * scale;
    }
    return;
  }

  // ---- topk: radix select of the k-th largest |xf| (as uint32 bits) ----
  unsigned prefix = 0, mask = 0, kk = static_cast<unsigned>(k);
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += THREADS) hist[b] = 0;
    __syncthreads();
    for (int i = tid; i < L; i += THREADS) {
      const unsigned key = __float_as_uint(fabsf(dl[i] + rs[i]));
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins 255-8l .. 248-8l, scanned from the top down
      unsigned c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) { c[j] = hist[255 - 8 * lane - j]; sum += c[j]; }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned n = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += n;
      }
      unsigned cum = incl - sum;
      if (cum < kk && incl >= kk) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (cum + c[j] >= kk) {
            s_prefix = prefix | (static_cast<unsigned>(255 - 8 * lane - j) << shift);
            s_kk = kk - cum;
            break;
          }
          cum += c[j];
        }
      }
    }
    __syncthreads();
    prefix = s_prefix;
    kk = s_kk;
    mask |= 255u << shift;
  }
  const float thresh = __uint_as_float(prefix);

  // float comparisons from here on, exactly as the reference's mask
  int n_above = 0;
  for (int base = 0; base < L; base += THREADS) {
    const int i = base + tid;
    n_above += __syncthreads_count(i < L && fabsf(dl[i] + rs[i]) > thresh);
  }
  const int need_eq = k - n_above;

  // index-ordered pass: the first need_eq entries equal to thresh are kept
  int taken = 0;
  for (int base = 0; base < L; base += THREADS) {
    const int i = base + tid;
    const float xf = i < L ? dl[i] + rs[i] : 0.0f;
    const float mag = fabsf(xf);
    const bool eq = i < L && mag == thresh;
    const unsigned ballot = __ballot_sync(FULL, eq);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = taken + __popc(ballot & ((1u << lane) - 1u));
    int chunk = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) before += s_warp[w];
      chunk += s_warp[w];
    }
    if (i < L) {
      const bool keep = mag > thresh || (eq && before < need_eq);
      o_dec[i] = keep ? xf : 0.0f;
      o_res[i] = keep ? 0.0f : xf;
    }
    taken += chunk;
    __syncthreads();  // s_warp is rewritten by the next chunk
  }
}

}  // namespace

extern "C" int delta_codec_launch(const float* delta, const float* residual,
                                  float* dec, float* res, int A, int L,
                                  int codec, int k, void* stream) {
  if (A <= 0 || L <= 0 || codec < kFloat32 || codec > kTopk ||
      (codec == kTopk && k < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  delta_codec_kernel<<<A, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      delta, residual, dec, res, L, codec, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* delta_codec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
