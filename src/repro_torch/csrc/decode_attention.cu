// K5 decode_attention: one query token of GQA attention over the valid
// prefix of a KV cache, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:110
// (decode_attention -> decode_attention_bhd :66, body _decode_kernel :29).
// Plain version: repro_torch/kernels/ref.py::decode_attention_ref.
//
// q (B, 1, Hq, D), k/v caches (B, S_max, Hkv, D), all contiguous; the output
// (B, 1, Hq, D) takes q's type. Query head h reads kv head h / G, G = Hq/Hkv.
//
// One block of 256 threads per (batch row, kv head). The G query heads that
// share the kv head are staged once in shared memory (float32), so every K/V
// tile is read from device memory once for the whole group. The block walks
// the cache in tiles of TK keys up to kv_len only: keys at or past kv_len are
// never loaded, so garbage there cannot reach the result. Per tile:
//   1. K and V rows to shared memory as float32 (16-byte vector loads);
//   2. the G x TK scores, one (head, key) pair per thread, q . k * 1/sqrt(D);
//   3. the online-softmax update in float32, one warp per query head:
//      m' = max(m, max s), p = exp(s - m'), l' = l exp(m - m') + sum p;
//   4. acc[g][d] = acc[g][d] exp(m - m') + sum_j p[g][j] v[j][d], one
//      (head, d) pair per thread, acc kept in shared memory.
// Finally out = acc / max(l, 1e-30), rounded once to the output type.
//
// Bound: by bytes. Each valid K/V row is read once: 2 * B * kv_len * Hkv *
// D * sizeof(T), plus q and out. At B=64, kv_len 4096, Hkv=2, D=64 in bf16
// that is 134 MB, 40.1 us at 3.35 TB/s; at the serve path's B <= 8,
// kv_len 17 it is ~0.03 us and the launch sets the time. This design keeps
// one block per (b, kv head) with no split of the cache across blocks and
// loads each tile synchronously, so a long cache at small B*Hkv leaves
// most SMs idle and memory latency exposed; split-K and asynchronous copies
// are later work. The dot products use explicit fmaf (the build's
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of T at p (16-byte aligned) as float32 into dst.
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
__host__ __device__ constexpr int tile_keys() { return D <= 128 ? 64 : 32; }

// Shared-memory floats of one block for G query heads.
template <int D>
constexpr size_t smem_floats(int g) {
  return static_cast<size_t>(g) * D * 2            // q, acc
         + static_cast<size_t>(tile_keys<D>()) * (D + 1)   // K (padded rows)
         + static_cast<size_t>(tile_keys<D>()) * D         // V
         + static_cast<size_t>(g) * tile_keys<D>()         // scores / p
         + 3 * static_cast<size_t>(g);                     // m, l, corr
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, TQ* __restrict__ out, int Hq, int Hkv,
    int S_max, int kv_len, float scale) {
  constexpr int TK = tile_keys<D>();
  constexpr int DP = D + 1;
  const int G = Hq / Hkv;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;                  // [G][D]
  float* acc = qs + G * D;           // [G][D]
  float* ks = acc + G * D;           // [TK][DP]
  float* vs = ks + TK * DP;          // [TK][D]
  float* ps = vs + TK * D;           // [G][TK]
  float* ms = ps + G * TK;           // [G]
  float* ls = ms + G;                // [G]
  float* cs = ls + G;                // [G]

  const TQ* qb = q + (static_cast<size_t>(b) * Hq + hk * G) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    qs[i] = to_f(qb[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }

  constexpr int EPC = 16 / sizeof(TKV);   // elements per 16-byte chunk
  constexpr int CPR = D / EPC;            // chunks per row
  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const TKV* kb = k + static_cast<size_t>(b) * S_max * row_stride + hk * D;
  const TKV* vb = v + static_cast<size_t>(b) * S_max * row_stride + hk * D;

  for (int t0 = 0; t0 < kv_len; t0 += TK) {
    const int n = min(TK, kv_len - t0);
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < TK * CPR; i += THREADS) {
      const int j = i / CPR, c = (i % CPR) * EPC;
      float kx[EPC], vx[EPC];
      if (j < n) {
        const size_t off = static_cast<size_t>(t0 + j) * row_stride + c;
        load16(kb + off, kx);
        load16(vb + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        ks[j * DP + c + e] = kx[e];
        vs[j * D + c + e] = vx[e];
      }
    }
    __syncthreads();
    // scores: one (head, key) pair per thread, consecutive keys per warp
    for (int i = tid; i < G * TK; i += THREADS) {
      const int g = i / TK, j = i % TK;
      const float* qr = qs + g * D;
      const float* kr = ks + j * DP;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      ps[i] = j < n ? s * scale : NEG_INF;
    }
    __syncthreads();
    // online softmax, one warp per query head
    for (int g = warp; g < G; g += WARPS) {
      float* pr = ps + g * TK;
      float mx = NEG_INF;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = j < n ? expf(pr[j] - m_new) : 0.f;
        pr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p . V, one (head, d) pair per thread
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      const float* pr = ps + g * TK;
      float a = 0.f;
      for (int j = 0; j < n; ++j) a = fmaf(pr[j], vs[j * D + d], a);
      acc[i] = acc[i] * cs[g] + a;
    }
  }
  __syncthreads();
  TQ* ob = out + (static_cast<size_t>(b) * Hq + hk * G) * D;
  for (int i = tid; i < G * D; i += THREADS)
    store(ob + i, acc[i] / fmaxf(ls[i / D], 1e-30f));
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int S_max, int kv_len, cudaStream_t stream) {
  const size_t smem = smem_floats<D>(Hq / Hkv) * sizeof(float);
  auto kern = decode_kernel<TQ, TKV, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<B * Hkv, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(out), Hq, Hkv, S_max,
      kv_len, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int by_dim(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int D, int S_max, int kv_len, cudaStream_t s) {
  switch (D) {
    case 32: return launch<TQ, TKV, 32>(q, k, v, out, B, Hq, Hkv, S_max, kv_len, s);
    case 64: return launch<TQ, TKV, 64>(q, k, v, out, B, Hq, Hkv, S_max, kv_len, s);
    case 80: return launch<TQ, TKV, 80>(q, k, v, out, B, Hq, Hkv, S_max, kv_len, s);
    case 128: return launch<TQ, TKV, 128>(q, k, v, out, B, Hq, Hkv, S_max, kv_len, s);
    case 256: return launch<TQ, TKV, 256>(q, k, v, out, B, Hq, Hkv, S_max, kv_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Shared memory one block needs (bytes), or 0 for an unsupported D.
extern "C" long long decode_attention_smem_bytes(int G, int D) {
  switch (D) {
    case 32: return static_cast<long long>(smem_floats<32>(G) * 4);
    case 64: return static_cast<long long>(smem_floats<64>(G) * 4);
    case 80: return static_cast<long long>(smem_floats<80>(G) * 4);
    case 128: return static_cast<long long>(smem_floats<128>(G) * 4);
    case 256: return static_cast<long long>(smem_floats<256>(G) * 4);
    default: return 0;
  }
}

// q_type / kv_type: 0 = float32, 1 = bfloat16.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* out, int B,
                                       int Hq, int Hkv, int D, int S_max,
                                       int kv_len, int q_type, int kv_type,
                                       void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || kv_len <= 0 || kv_len > S_max)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == 0 && kv_type == 0)
    return by_dim<float, float>(q, k, v, out, B, Hq, Hkv, D, S_max, kv_len, s);
  if (q_type == 0 && kv_type == 1)
    return by_dim<float, __nv_bfloat16>(q, k, v, out, B, Hq, Hkv, D, S_max, kv_len, s);
  if (q_type == 1 && kv_type == 0)
    return by_dim<__nv_bfloat16, float>(q, k, v, out, B, Hq, Hkv, D, S_max, kv_len, s);
  if (q_type == 1 && kv_type == 1)
    return by_dim<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, B, Hq, Hkv, D, S_max, kv_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
