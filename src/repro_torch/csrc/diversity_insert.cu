// K1 diversity_insert: the Eq. 6 streaming buffer ingest, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/diversity.py:93
// (diversity_insert -> _diversity_kernel). Plain version:
// repro_torch/kernels/ref.py::diversity_insert_ref.
//
// One block of one warp per agent ingests that agent's T candidates in
// order. For each candidate: score it from the streaming moments (8x8
// Cholesky with ridge, forward solve, clipped KL against p_sum/n), take the
// warp argmin over the N slot scores (empty slots hold -inf; NaN first,
// then lowest index on ties, as jnp.argmin), insert iff d > min, and apply
// the rank-1 add/subtract of the moments. The buffer slots, the moments and
// the candidates live in shared memory for the whole chain: global memory
// sees one load and one store of the agent's buffer per episode.
//
// Bound: about 7.7 KB read and 6.9 KB written per agent at N=64, D=8,
// NA=15, T=10, i.e. ~9 us of HBM time at A=2048 on an H100 (3.35 TB/s).
// The T-step serial chain (each Cholesky-and-solve on one lane) and the
// launch set the time at small A, not the bytes.
//
// Numerics: built with -fmad=false (no contraction), IEEE division and
// sqrtf, logf (not the __ intrinsics); sums run left to right in the
// reference's order.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int D = 8;           // state_dim: the Cholesky is unrolled over it
constexpr unsigned FULL = 0xffffffffu;

// jnp.maximum / jnp.clip: NaN propagates (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float nan_clip(float x, float lo, float hi) {
  return (x != x) ? x : fminf(fmaxf(x, lo), hi);
}

// jnp.argmin order: NaN is the minimum; equal values -> lower index.
__device__ __forceinline__ bool precedes(float v, int i, float w, int j) {
  const bool vn = v != v, wn = w != w;
  if (vn || wn) return vn && (!wn || i < j);
  return v < w || (v == w && i < j);
}

// Eq. 6 score of one candidate from the moments (one lane, serial).
__device__ float score_from_moments(const float* s, const float* p,
                                    const float* s_sum, const float* s_outer,
                                    const float* p_sum, int n_fill, int na,
                                    float alpha, float beta, float ridge) {
  const float n = nan_max(static_cast<float>(n_fill), 1.0f);
  float mu[D];
#pragma unroll
  for (int i = 0; i < D; ++i) mu[i] = s_sum[i] / n;
  // lower triangle: cov, overwritten in place by its Cholesky factor
  float l[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      l[i][j] = (s_outer[i * D + j] / n - mu[i] * mu[j]) +
                (i == j ? ridge : 0.0f);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc + l[j][k] * l[j][k];
    const float ljj = sqrtf(nan_max(l[j][j] - acc, 1e-12f));
    l[j][j] = ljj;
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      float dots = 0.0f;
#pragma unroll
      for (int k = 0; k < j; ++k) dots = dots + l[i][k] * l[j][k];
      l[i][j] = (l[i][j] - dots) / ljj;
    }
  }
  float y[D];
  float dm2 = 0.0f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < i; ++k) acc = acc + l[i][k] * y[k];
    y[i] = ((s[i] - mu[i]) - acc) / l[i][i];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) dm2 = dm2 + y[i] * y[i];
  const float d_m = sqrtf(nan_max(dm2, 0.0f));
  float kl = 0.0f;
  for (int k = 0; k < na; ++k) {
    const float mp = n_fill > 0 ? p_sum[k] / n : p[k];
    const float pc = nan_clip(p[k], 1e-8f, 1.0f);
    const float qc = nan_clip(mp, 1e-8f, 1.0f);
    kl = kl + pc * logf(pc / qc);
  }
  return alpha * d_m + beta * kl;
}

__global__ void __launch_bounds__(32) diversity_insert_kernel(
    const float* __restrict__ states, const float* __restrict__ probs,
    const float* __restrict__ score, const bool* __restrict__ filled,
    const float* __restrict__ s_sum, const float* __restrict__ s_outer,
    const float* __restrict__ p_sum, const int* __restrict__ n_filled,
    const float* __restrict__ cand_states,
    const float* __restrict__ cand_probs, float* __restrict__ o_states,
    float* __restrict__ o_probs, float* __restrict__ o_score,
    bool* __restrict__ o_filled, float* __restrict__ o_ssum,
    float* __restrict__ o_souter, float* __restrict__ o_psum,
    int* __restrict__ o_nfill, int* __restrict__ o_slot,
    bool* __restrict__ o_do, float* __restrict__ o_d, int N, int NA, int T,
    float alpha, float beta, float ridge) {
  extern __shared__ float smem[];
  const int a = blockIdx.x;
  const int lane = threadIdx.x;
  float* st = smem;             // N*D   slot states
  float* pr = st + N * D;       // N*NA  slot probs
  float* sc = pr + N * NA;      // N     slot scores
  float* cs = sc + N;           // T*D   candidate states
  float* cp = cs + T * D;       // T*NA  candidate probs
  float* ss = cp + T * NA;      // D     s_sum
  float* so = ss + D;           // D*D   s_outer
  float* ps = so + D * D;       // NA    p_sum
  bool* fl = reinterpret_cast<bool*>(ps + NA);  // N filled
  __shared__ int nfill;

  for (int i = lane; i < N * D; i += 32) st[i] = states[(size_t)a * N * D + i];
  for (int i = lane; i < N * NA; i += 32) pr[i] = probs[(size_t)a * N * NA + i];
  for (int i = lane; i < N; i += 32) {
    sc[i] = score[(size_t)a * N + i];
    fl[i] = filled[(size_t)a * N + i];
  }
  for (int i = lane; i < T * D; i += 32) cs[i] = cand_states[(size_t)a * T * D + i];
  for (int i = lane; i < T * NA; i += 32) cp[i] = cand_probs[(size_t)a * T * NA + i];
  for (int i = lane; i < D; i += 32) ss[i] = s_sum[(size_t)a * D + i];
  for (int i = lane; i < D * D; i += 32) so[i] = s_outer[(size_t)a * D * D + i];
  for (int i = lane; i < NA; i += 32) ps[i] = p_sum[(size_t)a * NA + i];
  if (lane == 0) nfill = n_filled[a];
  __syncwarp();

  for (int t = 0; t < T; ++t) {
    const float* s = cs + t * D;
    const float* p = cp + t * NA;
    float d = 0.0f;
    if (lane == 0)
      d = score_from_moments(s, p, ss, so, ps, nfill, NA, alpha, beta, ridge);
    d = __shfl_sync(FULL, d, 0);

    // warp argmin over the slot scores
    int bi = lane < N ? lane : 0;
    float bv = sc[bi];
    for (int j = lane + 32; j < N; j += 32)
      if (precedes(sc[j], j, bv, bi)) { bv = sc[j]; bi = j; }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(FULL, bv, off);
      const int oi = __shfl_down_sync(FULL, bi, off);
      if (precedes(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    const float minval = __shfl_sync(FULL, bv, 0);
    const int idx = __shfl_sync(FULL, bi, 0);
    const bool ins = d > minval;              // -inf (empty) accepts always
    const bool evict = ins && (minval != -INFINITY);
    const float add = ins ? 1.0f : 0.0f;
    const float sub = evict ? 1.0f : 0.0f;

    // rank-1 add of the candidate, subtract of the evicted occupant
    const float* old_s = st + idx * D;
    const float* old_p = pr + idx * NA;
    for (int e = lane; e < D * D; e += 32) {
      const int i = e / D, j = e % D;
      so[e] = so[e] + add * (s[i] * s[j]) - sub * (old_s[i] * old_s[j]);
    }
    for (int e = lane; e < D; e += 32) ss[e] = ss[e] + add * s[e] - sub * old_s[e];
    for (int e = lane; e < NA; e += 32) ps[e] = ps[e] + add * p[e] - sub * old_p[e];
    __syncwarp();  // every lane has read the old occupant before it goes

    if (ins) {
      for (int e = lane; e < D; e += 32) st[idx * D + e] = s[e];
      for (int e = lane; e < NA; e += 32) pr[idx * NA + e] = p[e];
    }
    if (lane == 0) {
      if (ins) { sc[idx] = d; fl[idx] = true; }
      nfill = nfill + (ins ? 1 : 0) - (evict ? 1 : 0);
      o_slot[(size_t)a * T + t] = idx;
      o_do[(size_t)a * T + t] = ins;
      o_d[(size_t)a * T + t] = d;
    }
    __syncwarp();
  }

  for (int i = lane; i < N * D; i += 32) o_states[(size_t)a * N * D + i] = st[i];
  for (int i = lane; i < N * NA; i += 32) o_probs[(size_t)a * N * NA + i] = pr[i];
  for (int i = lane; i < N; i += 32) {
    o_score[(size_t)a * N + i] = sc[i];
    o_filled[(size_t)a * N + i] = fl[i];
  }
  for (int i = lane; i < D; i += 32) o_ssum[(size_t)a * D + i] = ss[i];
  for (int i = lane; i < D * D; i += 32) o_souter[(size_t)a * D * D + i] = so[i];
  for (int i = lane; i < NA; i += 32) o_psum[(size_t)a * NA + i] = ps[i];
  if (lane == 0) o_nfill[a] = nfill;
}

}  // namespace

extern "C" int diversity_insert_launch(
    const float* states, const float* probs, const float* score,
    const bool* filled, const float* s_sum, const float* s_outer,
    const float* p_sum, const int* n_filled, const float* cand_states,
    const float* cand_probs, float* o_states, float* o_probs, float* o_score,
    bool* o_filled, float* o_ssum, float* o_souter, float* o_psum,
    int* o_nfill, int* o_slot, bool* o_do, float* o_d, int A, int N,
    int dim, int NA, int T, float alpha, float beta, float ridge,
    void* stream) {
  if (dim != D || A <= 0 || N <= 0 || T <= 0 || NA <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (size_t)(N * D + N * NA + N + T * D + T * NA + D +
                               D * D + NA) + sizeof(bool) * N;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        diversity_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  diversity_insert_kernel<<<A, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      states, probs, score, filled, s_sum, s_outer, p_sum, n_filled,
      cand_states, cand_probs, o_states, o_probs, o_score, o_filled, o_ssum,
      o_souter, o_psum, o_nfill, o_slot, o_do, o_d, N, NA, T, alpha, beta,
      ridge);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* diversity_insert_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
