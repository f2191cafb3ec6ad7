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
// reference's. D is one of 32, 64, 80, 128, 256. The TPU kernel's sequential
// kv grid axis becomes a loop inside the block; tiles wholly above the
// causal diagonal are skipped (they add exactly 0).
//
// Bound: by operations. 4 B Hq Sq Sk D flops (half of it under the causal
// mask); at B=4, S=2048, Hq=14, D=64 causal in bf16 that is 30.1 GFLOP per
// layer, 30.4 us at the tensor cores' 989 TFLOP/s (its 33.6 MB take 10 us).
//
// Two kernels, chosen by type:
//
// bf16: flash_bf16_kernel, on the tensor cores. One block per (q tile,
// q head, batch row), the heaviest causal q tiles launched first. NWG
// consumer warpgroups each own 64 query rows; a producer warpgroup, one
// thread of which issues the copies, keeps TMA loads of K and V tiles (BN
// keys) in flight into a ring of STAGES stages, each tile signalled by an
// mbarrier (full: its bytes landed; ek / ev: every consumer thread is done
// with the stage's K / V). The Q tile is loaded once by TMA. With two
// consumer warpgroups the producer gives its registers to them
// (setmaxnreg: 168 a thread at launch, 24 for the producer, 240 for the
// consumers). Per kv tile t a consumer warpgroup
//   1. issues S_{t+1} = Q K_{t+1}^T by wgmma from shared memory (bf16 x
//      bf16 -> float32) before it works on S_t;
//   2. masks S_t only where the tile crosses the causal diagonal or Sk;
//   3. runs the online softmax in float32 registers (m, l per row, exp2 of
//      s log2(e)/sqrt(D) - m);
//   4. rounds P to bf16 in registers, where the S accumulator's layout is
//      wgmma's A-operand layout, and accumulates O += P V by wgmma with V
//      in shared memory (O in float32 registers, rescaled by exp(m - m')).
// ptxas reports (C7515) that it serializes these wgmma, because O is
// rescaled in registers while S_{t+1} is in flight, so the overlap of
// step 1 with steps 2-4 is partial. Finally O / max(l, 1e-30), rounded
// once to bf16. The (B, S, H, D) layout
// is read in place through 4-d tensor maps over (D, H, S, B) with a box of
// (64, 1, rows, 1): one head's rows, 64 columns (128 bytes, the 128-byte
// swizzle) per box; D = 32 and 80 take whole 64-column chunks, the columns
// past D filled with zeros by TMA (they add exactly 0 to S and O), as are
// rows past Sq or Sk (keys past Sk are masked to -inf before the max). The
// wgmma shared-memory descriptors name the same 128-byte swizzle: K-major
// Q and K (8-row groups 1024 bytes apart), MN-major V (the same groups
// along the keys). Rounding P to bf16 before P V is the one place this
// departs from the float32 plain version, as PyTorch's SDPA does.
// Registers (ptxas, sm_90a): 168 at launch for D <= 128 (240 in the
// consumers), 238 for D = 256 (one consumer warpgroup, 256 threads); no
// spills.
//
// float32: flash_f32_kernel, on the CUDA cores (the float32 path is held
// within 2e-5, which the tensor cores' TF32 could not hold). One block of
// 256 threads per (q tile of BQ rows, q head, batch row). Per kv tile:
// K and V rows to shared memory (16-byte vector loads); S = Q K^T / sqrt(D)
// with the 16 x 16 threads each owning an RM x CN register tile; the online
// softmax in float32, one warp per BQ/8 rows; acc = acc exp(m - m') + P V,
// each thread an RM x D/16 register tile; IEEE expf. Its inner loops are
// bound by shared-memory loads, about two per four fmaf.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

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

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
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
template <int D, int DP>
__device__ __forceinline__ void load_rows(const float* base,
                                          size_t row_stride, int r0,
                                          int rows, int S, float* dst) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
    const int r = i / CPR, c = (i % CPR) * 4;
    float x[4];
    if (r0 + r < S) {
      load16(base + static_cast<size_t>(r0 + r) * row_stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[r * DP + c + e] = x[e];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
    int Hq, int Hkv, int causal, float scale) {
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
  load_rows<D, DP>(q + static_cast<size_t>(b) * Sq * q_stride + h * D,
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

  const float* kb = k + static_cast<size_t>(b) * Sk * kv_stride + hk * D;
  const float* vb = v + static_cast<size_t>(b) * Sk * kv_stride + hk * D;
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done
    load_rows<D, DP>(kb, kv_stride, k0, BK, Sk, ks);
    load_rows<D, DP>(vb, kv_stride, k0, BK, Sk, vs);
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
    float* orow = out + (static_cast<size_t>(b) * Sq + qpos) * q_stride + h * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) orow[tc + 16 * j] = acc[i][j] / l;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int Hq, int Hkv, int causal,
               cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_f32_kernel<D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int BQ = tile_rows<D>();
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, Hq, Hkv,
      causal, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA, mbarriers
// ---------------------------------------------------------------------------
template <int D>
struct Cfg {
  static constexpr int DP = D <= 64 ? 64 : (D <= 128 ? 128 : 256);
  static constexpr int CH = DP / 64;                // 128-byte column chunks
  static constexpr int BN = DP == 64 ? 128 : 64;    // keys per kv tile
  static constexpr int NWG = DP == 256 ? 1 : 2;     // consumer warpgroups
  static constexpr int BM = 64 * NWG;               // query rows per block
  static constexpr int STAGES = 2;
  static constexpr int THREADS = (NWG + 1) * 128;  // + a producer warpgroup
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;      // one K or V tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of the given parity has completed. A wait that
// outlasts ~2^34 clocks (about 10 s) traps: a fault, not a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (!t0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// One box of a 4-d tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile stored with the 128-byte swizzle
// (rows of 128 bytes, 8-row groups 1024 bytes apart: the stride byte
// offset; tiles 1024-aligned). The leading byte offset is unused by the
// products here (a K-major operand's 16-deep step stays inside one
// 128-byte row; an MN-major operand is 64 wide, one swizzle atom).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(1024 >> 4) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A in registers (bf16 pairs), B
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (BN == 128) wgmma_ss_n128(d, a, b, scale_d);
  else wgmma_ss_n64(d, a, b, scale_d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Accumulator fragment of a 64 x N wgmma, thread t of the warpgroup,
// register i: row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (t % 4) + i % 2.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    int B, int Sq, int Sk, int Hq, int Hkv, int causal, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BN = C::BN, CH = C::CH, ST = C::STAGES;
  constexpr int NS = BN / 2;                 // S accumulator registers
  extern __shared__ uint8_t smem_raw[];
  // full: a tile's bytes landed; ek / ev: every consumer thread is done
  // with a stage's K / V tile
  __shared__ uint64_t bar_q, bar_k[ST], bar_v[ST], bar_ek[ST], bar_ev[ST];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;                  // [NWG][CH][64][128 B]
  const uint32_t sk = sq + C::Q_BYTES;       // [ST][CH][BN][128 B]
  const uint32_t sv = sk + ST * C::KV_BYTES; // [ST][CH][BN][128 B]

  const int bh = Hq * B;
  const int n_qt = (Sq + C::BM - 1) / C::BM;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / bh);
  const int h = static_cast<int>(blockIdx.x % bh) % Hq;
  const int b = static_cast<int>(blockIdx.x % bh) / Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * C::BM;
  const int k_end = causal ? min(Sk, q0 + C::BM) : Sk;
  const int n_kt = (k_end + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_ek[s], C::NWG * 128);
      mbar_init(&bar_ev[s], C::NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::NWG * 4) {
    // producer warpgroup: one thread loads Q once, then K and V tiles
    // through the ring; with two consumer warpgroups the producer gives
    // its registers to them (launched at 168 a thread, 24 and 240 after)
    if constexpr (C::NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == C::NWG * 4 && lane == 0) {
      mbar_expect_tx(&bar_q, C::Q_BYTES);
      for (int w = 0; w < C::NWG; ++w)
        for (int c = 0; c < CH; ++c)
          tma_load(sq + (w * CH + c) * 8192, &tq, &bar_q, c * 64, h,
                   q0 + 64 * w, b);
      for (int t = 0; t < n_kt; ++t) {
        const int s = t % ST, ph = (t / ST) & 1;
        mbar_wait(&bar_ek[s], ph ^ 1);
        mbar_expect_tx(&bar_k[s], C::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load(sk + s * C::KV_BYTES + c * BN * 128, &tk, &bar_k[s],
                   c * 64, hk, t * BN, b);
        mbar_wait(&bar_ev[s], ph ^ 1);
        mbar_expect_tx(&bar_v[s], C::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load(sv + s * C::KV_BYTES + c * BN * 128, &tv, &bar_v[s],
                   c * 64, hk, t * BN, b);
      }
    }
  } else {
    if constexpr (C::NWG == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // consumer warpgroup wg: query rows [qw, qw + 64); it computes tiles
    // [0, n_w), those wholly above its rows only release their stage
    const int wg = warp / 4;
    const int qw = q0 + 64 * wg;
    const int n_w = causal ? min(n_kt, (qw + 63) / BN + 1) : n_kt;
    const int row0 = qw + 16 * (warp % 4) + lane / 4;   // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t qa = sq + wg * CH * 8192;
    float o[CH][32];
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // S_t = Q K_t^T into dst, committed as one wgmma group (not waited for)
    auto issue_scores = [&](float (&dst)[NS], int t) {
      mbar_wait(&bar_k[t % ST], (t / ST) & 1);
      const uint32_t kt = sk + (t % ST) * C::KV_BYTES;
      reg_fence(dst);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::DP / 16; ++kk) {   // 16 columns of D per step
        const uint32_t off = (kk % 4) * 32;       // inside a 128-byte row
        wgmma_ss<BN>(dst, sw128_desc(qa + (kk / 4) * 8192 + off, 16),
                     sw128_desc(kt + (kk / 4) * BN * 128 + off, 16), kk > 0);
      }
      wgmma_commit();
    };

    // Tile t, with S_t in cur: S_{t+1} is issued into nxt first, so the
    // tensor cores compute it while this warpgroup runs the softmax of S_t.
    auto step = [&](float (&cur)[NS], float (&nxt)[NS], int t) {
      const int s = t % ST;
      if (t + 1 < n_w) {
        issue_scores(nxt, t + 1);
        wgmma_wait<1>();            // S_t and P V_{t-1} are done
      } else {
        wgmma_wait<0>();
      }
      reg_fence(cur);
#pragma unroll
      for (int c = 0; c < CH; ++c) reg_fence(o[c]);
      mbar_arrive(&bar_ek[s]);
      if (t > 0) mbar_arrive(&bar_ev[(t - 1) % ST]);
      // mask only where the tile crosses the causal diagonal or Sk
      const int k0 = t * BN;
      if (k0 + BN > Sk || (causal && k0 + BN - 1 > qw)) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int kpos = k0 + 8 * (i / 4) + col0 + (i % 2);
          const int row = row0 + 8 * ((i / 2) % 2);
          if (kpos >= Sk || (causal && kpos > row)) cur[i] = -INFINITY;
        }
      }
      // online softmax in log2 units, rows row0 (r = 0) and row0 + 8 (r = 1)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], cur[i]);
      float corr[2], mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = exp2f(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int r = (i / 2) % 2;
        cur[i] = exp2f(fmaf(cur[i], scale_log2, -mu[r]));
        l[r] += cur[i];
      }
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i / 2) % 2];
      // O += P V_t, P in bf16 as wgmma's A operand
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(cur[8 * kk + 2 * j], cur[8 * kk + 2 * j + 1]);
      mbar_wait(&bar_v[s], (t / ST) & 1);
      const uint32_t vt = sv + s * C::KV_BYTES;
#pragma unroll
      for (int c = 0; c < CH; ++c) reg_fence(o[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < CH; ++c)
          wgmma_rs_n64(o[c], pa[kk],
                       sw128_desc(vt + c * BN * 128 + kk * 16 * 128, 1024));
      wgmma_commit();
    };

    mbar_wait(&bar_q, 0);
    float sa[NS], sb[NS];
    issue_scores(sa, 0);
    for (int t = 0; t < n_w; t += 2) {
      step(sa, sb, t);
      if (t + 1 < n_w) step(sb, sa, t + 1);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < CH; ++c) reg_fence(o[c]);
    mbar_arrive(&bar_ev[(n_w - 1) % ST]);
    for (int t = n_w; t < n_kt; ++t) {   // above the diagonal: release only
      const int s = t % ST, ph = (t / ST) & 1;
      mbar_wait(&bar_k[s], ph);
      mbar_arrive(&bar_ek[s]);
      mbar_wait(&bar_v[s], ph);
      mbar_arrive(&bar_ev[s]);
    }

    // out = O / max(l, 1e-30), rounded once to bf16
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= Sq) continue;
      __nv_bfloat16* orow =
          out + ((static_cast<size_t>(b) * Sq + row) * Hq + h) * D;
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int n8 = 0; n8 < 8; ++n8) {
          const int col = 64 * c + 8 * n8 + col0;
          if (col < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[c][4 * n8 + 2 * r] * inv[r],
                                      o[c][4 * n8 + 2 * r + 1] * inv[r]);
        }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int ENCODE_ERROR = 100000;   // + CUresult of a failed encode

// A 4-d map over a (B, S, H, D) bf16 tensor as (D, H, S, B), box
// (64, 1, rows, 1), 128-byte swizzle, zeros outside the tensor.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
             int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * S * H * D};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_ERROR + static_cast<int>(r);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int Hq, int Hkv, int causal,
                cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, B, Sq, Hq, D, 64);
  if (!rc) rc = make_map(&tk, k, B, Sk, Hkv, D, C::BN);
  if (!rc) rc = make_map(&tv, v, B, Sk, Hkv, D, C::BN);
  if (rc) return rc;
  auto kern = flash_bf16_kernel<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((Sq + C::BM - 1) / C::BM) * Hq * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), B, Sq, Sk, Hq, Hkv,
      causal, 1.4426950408889634f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int Hq, int Hkv, int causal, int dtype,
           cudaStream_t s) {
  if (dtype == 0) return launch_f32<D>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, s);
  if (dtype == 1) return launch_bf16<D>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
  switch (D) {
    case 32: return launch<32>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, dtype, s);
    case 64: return launch<64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, dtype, s);
    case 80: return launch<80>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, dtype, s);
    case 128: return launch<128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, dtype, s);
    case 256: return launch<256>(q, k, v, out, B, Sq, Sk, Hq, Hkv, causal, dtype, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code >= ENCODE_ERROR) return "cuTensorMapEncodeTiled failed "
                                   "(CUresult = code - 100000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
