// K4 flash_attention: causal or bidirectional GQA attention (prefill),
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:112
// (flash_attention -> flash_attention_bhsd :74, body _flash_kernel :30).
// Plain version: repro_torch/kernels/ref.py::flash_attention_ref.
//
// q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), contiguous, one type (float32 or
// bf16); the output (B, Sq, Hq, D) has that type. Query head h reads kv head
// h / (Hq / Hkv) straight from k and v: no repeated kv in device memory.
// Causal masking is aligned at position 0 (query i sees keys j <= i), as the
// reference's.
//
// One block of 256 threads per (q tile of BQ rows, q head, batch row); the
// TPU kernel's sequential kv grid axis becomes a loop inside the block. Per
// kv tile of BK keys:
//   1. K and V rows to shared memory as float32 (16-byte vector loads);
//   2. S = Q K^T / sqrt(D): the 16 x 16 threads each own an RM x CN register
//      tile (RM = BQ/16 rows, CN = BK/16 strided columns), so one shared-
//      memory load feeds several fmaf; padded rows (D + 1) keep the loads
//      free of bank conflicts; masked entries (causal, or past Sk) are -1e30;
//   3. the online softmax in float32, one warp per BQ/8 rows:
//      m' = max(m, max s), p = exp(s - m') (0 where masked),
//      l' = l exp(m - m') + sum p;
//   4. acc = acc exp(m - m') + P V, each thread an RM x D/16 register tile.
// Tiles wholly above the causal diagonal are skipped (they add exactly 0).
// Finally out = acc / max(l, 1e-30), rounded once to the output type.
//
// Bound: by operations. 4 B Hq Sq Sk D flops (half of it under the causal
// mask); at B=4, S=2048, Hq=14, D=64 causal in bf16 that is 30.1 GFLOP per
// layer, 30.4 us at the tensor cores' 989 TFLOP/s (its 33.6 MB take 10 us).
// This kernel runs on the CUDA cores in float32 (the float32 path needs
// float32 products anyway), and its inner loops are bound by shared-memory
// loads, about two per four fmaf, so it sits one to two orders of magnitude
// above that bound; wgmma on bf16 tiles, TMA and a warp-specialised
// pipeline are later work. The products use explicit fmaf (the build's
// -fmad=false forbids only implicit contraction).
//
// Numerics: float32 throughout, IEEE expf (no fast math); agrees with the
// plain version to float32 roundoff (only the summation order differs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

template <int D>
__host__ __device__ constexpr int tile_rows() { return D <= 128 ? 64 : 32; }

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(3 * tile_rows<D>()) * (D + 1)    // Q, K, V
         + static_cast<size_t>(tile_rows<D>()) * (tile_rows<D>() + 1)  // S/P
         + 3 * static_cast<size_t>(tile_rows<D>());           // m, l, corr
}

// Rows [r0, r0 + rows) of one head of a (B, S, H, D) tensor into dst
// (rows x DP floats); rows at or past S are zeros.
template <typename T, int D, int DP>
__device__ __forceinline__ void load_rows(const T* base, size_t row_stride,
                                          int r0, int rows, int S,
                                          float* dst) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = D / EPC;
  for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    float x[EPC];
    if (r0 + r < S) {
      load16(base + static_cast<size_t>(r0 + r) * row_stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPC; ++e) dst[r * DP + c + e] = x[e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Sk, int Hq, int Hkv, int causal,
    float scale) {
  constexpr int BQ = tile_rows<D>(), BK = BQ;
  constexpr int RM = BQ / 16, CN = BK / 16, DN = D / 16;
  constexpr int DP = D + 1, SP = BK + 1;
  constexpr int RPW = BQ / WARPS;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid / 16, tc = tid % 16;

  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][DP]
  float* ks = qs + BQ * DP;      // [BK][DP]
  float* vs = ks + BK * DP;      // [BK][DP]
  float* ss = vs + BK * DP;      // [BQ][SP] scores, then p
  float* ms = ss + BQ * SP;      // [BQ]
  float* ls = ms + BQ;           // [BQ]
  float* cs = ls + BQ;           // [BQ]

  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  load_rows<T, D, DP>(q + static_cast<size_t>(b) * Sq * q_stride + h * D,
                      q_stride, q0, BQ, Sq, qs);
  for (int r = tid; r < BQ; r += THREADS) {
    ms[r] = NEG_INF;
    ls[r] = 0.f;
  }
  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;

  const T* kb = k + static_cast<size_t>(b) * Sk * kv_stride + hk * D;
  const T* vb = v + static_cast<size_t>(b) * Sk * kv_stride + hk * D;
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    load_rows<T, D, DP>(kb, kv_stride, k0, BK, Sk, ks);
    load_rows<T, D, DP>(vb, kv_stride, k0, BK, Sk, vs);
    __syncthreads();
    // 2. scores
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = qs[(tr * RM + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = ks[(tc + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = tr * RM + i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = tc + 16 * j, kpos = k0 + c;
        const bool ok = kpos < Sk && (!causal || qpos >= kpos);
        ss[r * SP + c] = ok ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();
    // 3. online softmax, one warp per RPW rows
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp * RPW + rr, qpos = q0 + r;
      float* sr = ss + r * SP;
      float mx = NEG_INF;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const int kpos = k0 + c;
        const bool ok = kpos < Sk && (!causal || qpos >= kpos);
        const float p = ok ? expf(sr[c] - m_new) : 0.f;
        sr[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cs[r] = corr;
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
      }
    }
    __syncthreads();
    // 4. acc = acc * corr + P V
    float pv[RM][DN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < DN; ++j) pv[i][j] = 0.f;
    const int n = min(BK, Sk - k0);
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      float p[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = ss[(tr * RM + i) * SP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = vs[c * DP + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) pv[i][j] = fmaf(p[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float corr = cs[tr * RM + i];
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] = acc[i][j] * corr + pv[i][j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = tr * RM + i, qpos = q0 + r;
    if (qpos >= Sq) continue;
    const float l = fmaxf(ls[r], 1e-30f);
    T* orow = out + (static_cast<size_t>(b) * Sq + qpos) * q_stride + h * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) store(orow + tc + 16 * j, acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int BQ = tile_rows<D>();
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, causal,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_dim(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int D, int causal,
           cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, s);
    case 80: return launch<T, 80>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, s);
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int Hq, int Hkv, int D,
                                      int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_dim<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, s);
  if (dtype == 1)
    return by_dim<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
