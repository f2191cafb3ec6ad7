// K5 decode_attention: one query token of GQA attention over the valid
// prefix of a KV cache, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:110
// (decode_attention -> decode_attention_bhd :66, body _decode_kernel :29).
// Plain version: repro_torch/kernels/ref.py::decode_attention_ref; the
// split-and-combine below is ref.py::decode_attention_split_ref.
//
// q (B, 1, Hq, D), k/v caches (B, S_max, Hkv, D), all contiguous; the output
// (B, 1, Hq, D) takes q's type. Query head h reads kv head h / G, G = Hq/Hkv.
//
// Bound: by bytes. Each valid K/V row is read once: 2 * B * kv_len * Hkv *
// D * sizeof(T), plus q and out. At B=64, kv_len 4096, Hkv=2, D=64 in bf16
// that is 134 MB, 40.1 us at 3.35 TB/s; at the serve path's B <= 8,
// kv_len 17 it is ~0.03 us and the launch sets the time.
//
// Split-KV. The grid is (split, kv head x head chunk, batch row): the cache
// prefix [0, kv_len) is cut into n_split ranges of `chunk` keys (a multiple
// of 64; the wrapper chooses n_split so that a long cache at small B * Hkv
// still fills the SMs, and one split for a short cache). A block of 128
// threads stages its query heads (up to GMAX = 8 of the group; a larger
// group takes several head chunks) once in shared memory as float32, and
// walks its range in tiles of TK keys, so each K/V row is read from device
// memory once for the whole chunk of heads. Tiles come by cp.async into a
// ring of STAGES stages: the next tile's bytes are in flight while this
// one is computed. Rows at or past kv_len are never read (the copy
// zero-fills them in shared memory), so garbage there cannot reach the
// result. Per tile:
//   1. scores q . k / sqrt(D), TPK threads per key (each a contiguous share
//      of the row's 16-byte chunks, then a shuffle sum), all heads at once;
//   2. the online-softmax update in float32, one warp per head:
//      m' = max(m, max s), p = exp(s - m'), l' = l exp(m - m') + sum p;
//   3. acc = acc exp(m - m') + P V in registers, each warp over its quarter
//      of the tile's keys, lanes over pairs of d.
// At the end the four warps' accumulators are summed. With one split the
// block writes out = acc / max(l, 1e-30) in q's type. Otherwise it writes
// its partial (m, l, acc) in float32 to scratch, and combine_kernel takes
//   m* = max m_i, w_i = exp(m_i - m*) (0 for a split with no key, m_i = -inf),
//   out = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30).
// Numerics: float32 throughout, IEEE expf; agrees with the plain version to
// float32 roundoff (only the summation order differs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 8;        // query heads per block
constexpr int STAGES = 2;
constexpr int MAX_SPLITS = 64;
constexpr unsigned FULL = 0xffffffffu;

template <typename TKV, int D>
struct Cfg {
  static constexpr int EPC = 16 / sizeof(TKV);        // elements per chunk
  static constexpr int CPR = D / EPC;                 // 16-byte chunks a row
  static constexpr int ROW = D * sizeof(TKV) + 16;    // padded smem row bytes
  static constexpr int TK = 2 * 64 * ROW <= 40960 ? 64
                            : (2 * 32 * ROW <= 40960 ? 32 : 16);
  static constexpr int TPK = THREADS / TK;            // threads per key
  static constexpr int CPT = CPR / TPK;               // chunks per thread
  static constexpr int NP = (D + 63) / 64;            // d pairs per lane
  static constexpr int STAGE = 2 * TK * ROW;          // K and V of a tile
  static constexpr int RED = WARPS * GMAX * D * 4;    // per-warp acc sums
  static constexpr int BUF = STAGES * STAGE > RED ? STAGES * STAGE : RED;
  static constexpr int SMEM = BUF + GMAX * D * 4 + TK * GMAX * 4 + 3 * GMAX * 4;
  static_assert(CPR % TPK == 0, "a key's chunks split evenly");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of T in shared memory as float32.
__device__ __forceinline__ void unpack16(const float* p, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}
// Elements d and d + 1 of a row in shared memory as float32.
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 bytes global -> shared; with ok false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// part: [B Hq][n_split][D] acc, then [B Hq][n_split] m, then l (float32).
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, TQ* __restrict__ out, float* __restrict__ part,
    int B, int Hq, int Hkv, int S_max, int kv_len, int chunk, float scale) {
  using C = Cfg<TKV, D>;
  constexpr int TK = C::TK, TPK = C::TPK, EPC = C::EPC, ROW = C::ROW;
  const int sp = blockIdx.x, n_split = gridDim.x;
  const int G = Hq / Hkv, n_hc = (G + GMAX - 1) / GMAX;
  const int hk = blockIdx.y / n_hc, hc = blockIdx.y % n_hc, b = blockIdx.z;
  const int h0 = hk * G + hc * GMAX;          // this block's first head
  const int gc = min(GMAX, G - hc * GMAX);    // and its number of heads
  const int t_begin = sp * chunk;
  const int t_end = min(kv_len, t_begin + chunk);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + TK - 1) / TK : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* buf = smem;                                   // the ring
  float* qs = reinterpret_cast<float*>(smem + C::BUF);   // [GMAX][D]
  float* ps = qs + GMAX * D;                             // [TK][GMAX]
  float* ms = ps + TK * GMAX;                            // [GMAX]
  float* ls = ms + GMAX;
  float* cs = ls + GMAX;

  const size_t row_stride = static_cast<size_t>(Hkv) * D;
  const TKV* kb = k + static_cast<size_t>(b) * S_max * row_stride + hk * D;
  const TKV* vb = v + static_cast<size_t>(b) * S_max * row_stride + hk * D;
  auto issue = [&](int t) {
    uint8_t* dst = buf + (t % STAGES) * C::STAGE;
    const int r0 = t_begin + t * TK, n = min(TK, t_end - r0);
    for (int i = tid; i < TK * C::CPR; i += THREADS) {
      const int j = i / C::CPR, c = i % C::CPR;
      const size_t off = static_cast<size_t>(r0 + (j < n ? j : 0)) *
                         row_stride + c * EPC;
      cp_async16(dst + j * ROW + c * 16, kb + off, j < n);
      cp_async16(dst + (TK + j) * ROW + c * 16, vb + off, j < n);
    }
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }
  // the queries, while the first tiles are in flight
  const TQ* qb = q + (static_cast<size_t>(b) * Hq + h0) * D;
  for (int i = tid; i < gc * D; i += THREADS) qs[i] = to_f(qb[i]);
  if (tid < GMAX) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }

  float acc[GMAX][C::NP][2];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int i = 0; i < C::NP; ++i) acc[g][i][0] = acc[g][i][1] = 0.f;

  const int kj = tid / TPK, kp = tid % TPK;      // phase 1: key, share
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile t landed; everyone is done with tile t - 1
    if (t + STAGES - 1 < n_tiles) issue(t + STAGES - 1);
    cp_async_commit();
    const uint8_t* kt = buf + (t % STAGES) * C::STAGE;
    const uint8_t* vt = kt + TK * ROW;
    const int n = min(TK, t_end - (t_begin + t * TK));

    // 1. scores of key kj for every head
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) s[g] = 0.f;
#pragma unroll
    for (int i = 0; i < C::CPT; ++i) {
      const int c = kp * C::CPT + i;
      float kx[EPC];
      unpack16(reinterpret_cast<const TKV*>(kt + kj * ROW + c * 16), kx);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < gc) {
          const float* qr = qs + g * D + c * EPC;
#pragma unroll
          for (int e = 0; e < EPC; ++e) s[g] = fmaf(qr[e], kx[e], s[g]);
        }
      }
    }
#pragma unroll
    for (int off = 1; off < TPK; off <<= 1)
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] += __shfl_xor_sync(FULL, s[g], off);
    if (kp == 0) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        ps[kj * GMAX + g] = kj < n ? s[g] * scale : -INFINITY;
    }
    __syncthreads();
    // 2. online softmax, one warp per head
    for (int g = warp; g < gc; g += WARPS) {
      float mx = -INFINITY;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, ps[j * GMAX + g]);
      mx = warp_max(mx);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = expf(ps[j * GMAX + g] - m_use);
        ps[j * GMAX + g] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_use);
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    // 3. acc = acc * corr + P V over this warp's keys
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < gc) {
        const float corr = cs[g];
#pragma unroll
        for (int i = 0; i < C::NP; ++i) {
          acc[g][i][0] *= corr;
          acc[g][i][1] *= corr;
        }
      }
    }
    const int j_end = min(n, (warp + 1) * (TK / WARPS));
    for (int j = warp * (TK / WARPS); j < j_end; ++j) {
      float p[GMAX];
      const float4 p0 = *reinterpret_cast<const float4*>(ps + j * GMAX);
      const float4 p1 = *reinterpret_cast<const float4*>(ps + j * GMAX + 4);
      p[0] = p0.x; p[1] = p0.y; p[2] = p0.z; p[3] = p0.w;
      p[4] = p1.x; p[5] = p1.y; p[6] = p1.z; p[7] = p1.w;
      const TKV* vr = reinterpret_cast<const TKV*>(vt + j * ROW);
#pragma unroll
      for (int i = 0; i < C::NP; ++i) {
        const int d = 2 * (lane + 32 * i);
        if (d < D) {
          const float2 x = pair(vr + d);
#pragma unroll
          for (int g = 0; g < GMAX; ++g) {
            if (g < gc) {
              acc[g][i][0] = fmaf(p[g], x.x, acc[g][i][0]);
              acc[g][i][1] = fmaf(p[g], x.y, acc[g][i][1]);
            }
          }
        }
      }
    }
  }

  // sum the four warps' accumulators (the ring's memory is free now)
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(buf);            // [WARPS][GMAX][D]
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g < gc) {
#pragma unroll
      for (int i = 0; i < C::NP; ++i) {
        const int d = 2 * (lane + 32 * i);
        if (d < D) {
          red[(warp * GMAX + g) * D + d] = acc[g][i][0];
          red[(warp * GMAX + g) * D + d + 1] = acc[g][i][1];
        }
      }
    }
  }
  __syncthreads();
  const size_t bh0 = static_cast<size_t>(b) * Hq + h0;
  for (int e = tid; e < gc * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a += red[(w * GMAX + g) * D + d];
    if (n_split == 1)
      store(out + (bh0 + g) * D + d, a / fmaxf(ls[g], 1e-30f));
    else
      part[((bh0 + g) * n_split + sp) * D + d] = a;
  }
  if (n_split > 1 && tid < gc) {
    const size_t n_bh = static_cast<size_t>(B) * Hq;
    float* pm = part + n_bh * n_split * D;
    pm[(bh0 + tid) * n_split + sp] = ms[tid];
    pm[n_bh * n_split + (bh0 + tid) * n_split + sp] = ls[tid];
  }
}

// One block per (batch row, query head): the n_split partials combined.
template <typename TQ>
__global__ void __launch_bounds__(THREADS) combine_kernel(
    const float* __restrict__ part, TQ* __restrict__ out, int n_bh,
    int n_split, int D) {
  __shared__ float w[MAX_SPLITS];
  __shared__ float inv_l;
  const size_t bh = blockIdx.x;
  const float* pm = part + static_cast<size_t>(n_bh) * n_split * D;
  const float* pl = pm + static_cast<size_t>(n_bh) * n_split;
  if (threadIdx.x < 32) {
    float mx = -INFINITY;
    for (int i = threadIdx.x; i < n_split; i += 32)
      mx = fmaxf(mx, pm[bh * n_split + i]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int i = threadIdx.x; i < n_split; i += 32) {
      const float m_i = pm[bh * n_split + i];
      const float w_i = m_i == -INFINITY ? 0.f : expf(m_i - mx);
      w[i] = w_i;
      l += w_i * pl[bh * n_split + i];
    }
    l = warp_sum(l);
    if (threadIdx.x == 0) inv_l = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* pa = part + bh * n_split * D;
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float a = 0.f;
    for (int i = 0; i < n_split; ++i) a = fmaf(w[i], pa[i * D + d], a);
    store(out + bh * D + d, a * inv_l);
  }
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* part, int B, int Hq, int Hkv, int S_max, int kv_len,
           int n_split, int chunk, cudaStream_t stream) {
  using C = Cfg<TKV, D>;
  auto kern = decode_split_kernel<TQ, TKV, D>;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int G = Hq / Hkv, n_hc = (G + GMAX - 1) / GMAX;
  const dim3 grid(n_split, Hkv * n_hc, B);
  kern<<<grid, THREADS, C::SMEM, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(out),
      static_cast<float*>(part), B, Hq, Hkv, S_max, kv_len, chunk,
      1.0f / sqrtf(static_cast<float>(D)));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  combine_kernel<TQ><<<B * Hq, THREADS, 0, stream>>>(
      static_cast<const float*>(part), static_cast<TQ*>(out), B * Hq,
      n_split, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename TQ, typename TKV>
int by_dim(const void* q, const void* k, const void* v, void* out, void* part,
           int B, int Hq, int Hkv, int D, int S_max, int kv_len, int n_split,
           int chunk, cudaStream_t s) {
  switch (D) {
    case 32: return launch<TQ, TKV, 32>(q, k, v, out, part, B, Hq, Hkv, S_max, kv_len, n_split, chunk, s);
    case 64: return launch<TQ, TKV, 64>(q, k, v, out, part, B, Hq, Hkv, S_max, kv_len, n_split, chunk, s);
    case 80: return launch<TQ, TKV, 80>(q, k, v, out, part, B, Hq, Hkv, S_max, kv_len, n_split, chunk, s);
    case 128: return launch<TQ, TKV, 128>(q, k, v, out, part, B, Hq, Hkv, S_max, kv_len, n_split, chunk, s);
    case 256: return launch<TQ, TKV, 256>(q, k, v, out, part, B, Hq, Hkv, S_max, kv_len, n_split, chunk, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_type / kv_type: 0 = float32, 1 = bfloat16. part: float32 scratch of
// B * Hq * n_split * (D + 2) values, unused (may be null) when n_split = 1.
// Split i covers keys [i * chunk, min((i + 1) * chunk, kv_len)).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, void* out, void* part,
                                       int B, int Hq, int Hkv, int D,
                                       int S_max, int kv_len, int n_split,
                                       int chunk, int q_type, int kv_type,
                                       void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || kv_len <= 0 ||
      kv_len > S_max || n_split < 1 || n_split > MAX_SPLITS ||
      chunk <= 0 || chunk % 64 != 0 ||
      static_cast<long long>(n_split) * chunk < kv_len ||
      (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == 0 && kv_type == 0)
    return by_dim<float, float>(q, k, v, out, part, B, Hq, Hkv, D, S_max, kv_len, n_split, chunk, s);
  if (q_type == 0 && kv_type == 1)
    return by_dim<float, __nv_bfloat16>(q, k, v, out, part, B, Hq, Hkv, D, S_max, kv_len, n_split, chunk, s);
  if (q_type == 1 && kv_type == 0)
    return by_dim<__nv_bfloat16, float>(q, k, v, out, part, B, Hq, Hkv, D, S_max, kv_len, n_split, chunk, s);
  if (q_type == 1 && kv_type == 1)
    return by_dim<__nv_bfloat16, __nv_bfloat16>(q, k, v, out, part, B, Hq, Hkv, D, S_max, kv_len, n_split, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
