// K1 diversity_insert: the Eq. 6 streaming buffer ingest, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/diversity.py:93
// (diversity_insert -> _diversity_kernel). Plain version:
// repro_torch/kernels/ref.py::diversity_insert_ref.
//
// One block of two warps per agent ingests that agent's T candidates in
// order. Each candidate is scored from the streaming moments (8x8 Cholesky
// with ridge, forward solve, clipped KL against p_sum/n), the slot with the
// lowest score is found (empty slots hold -inf; NaN first, then the lowest
// index on ties, as jnp.argmin), the candidate goes in iff d > min, and the
// moments take the rank-1 add/subtract.
//
// The chain of candidates is walked two at a time. The slot candidate t
// would take is known before t is scored (the argmin depends only on the
// scores left by t - 1), so the moments candidate t + 1 will see are one of
// two states known in advance: t stays out, or t goes into that slot. A
// factor needs 9 lanes (8 rows of the covariance and, as a ninth row, the
// forward solve L y = b with b = s - mu, whose row is y), so warp 0 runs
// three factors in the same instructions: t on today's moments (lanes
// 0-8), t + 1 if t stays out (9-17) and t + 1 if t goes in (18-26). Within
// a factor, lane j forms l[j][j], lanes i > j form l[i][j] in parallel, and
// after each column every lane adds its new term to the sums of the columns
// to come, so a column waits only for one shuffle of its last term.
// Warp 1 meanwhile takes the three lowest slot scores (redux.sync minima of
// an integer key in jnp.argmin's order) and the three clipped KLs (NA lanes
// each). One barrier a pair joins them: both warps decide t, then t + 1
// from the factor of the state t left, and apply both inserts to the state
// each owns (warp 0: s_outer and s_sum in registers, lane L holding entries
// L and L + 32 of s_outer and s_sum[L % 8], and the slots' states; warp 1:
// p_sum, the slots' probs, scores and filled flags, and the trace). Warp 0
// then has the next pair's slot from the three lowest scores and the two
// decisions, without reading the scores again. Slots and candidates stay in
// shared memory for the whole chain (loaded with cp.async): global memory
// sees one load and one store of the agent's buffer. At most 64 registers
// a thread, so 16 agents fit on an SM and A=2048 runs in one wave on 132
// SMs.
//
// Bound: about 7.7 KB read and 6.9 KB written per agent at N=64, D=8,
// NA=15, T=10, i.e. ~9 us of HBM time at A=2048 on an H100 (3.35 TB/s).
// What sets the time at small A is the chain of the factor's columns: per
// column one sqrtf, one division (IEEE, each behind a branch to its slow
// path) and one shuffle, ~430 cycles, D columns per pair of candidates; at
// A=2048 it is the issue of the 32 warps an SM holds (every phase takes
// about twice its time at A=8), plus the load and store at the ends.
//
// Numerics: built with -fmad=false (no contraction), IEEE division and
// sqrtf, logf (not the __ intrinsics). Every value is formed by the same
// operations in the same order as in the one-lane kernel it replaces (sums
// left to right; the state that t leaves is formed by t's literal update,
// its 0 or 1 factors included), so the results are bit for bit that
// kernel's. A division by n = max(n_filled, 1) is a product with 1/n where
// n is a power of two (a full buffer of 64): both round the same real
// number, so the float is the same.
#include <cuda_runtime.h>
#include <math.h>

// Phase marks, empty here: a timing build (chip_smoke.py) defines
// K1_PHASE_MARKS and these three as clock64() stamps at the boundaries of
// the kernel's phases; the kernel as built carries no timing code.
#ifndef K1_PHASE_MARKS
#define K1_MARK_START()
#define K1_MARK(phase)
#define K1_MARK_END()
#endif

namespace {

constexpr int D = 8;           // state_dim: the factor is unrolled over it
constexpr int ROWS = D + 1;    // a factor's lanes: D rows and the solve
constexpr int STATES = 3;      // t; t + 1 if t stays out; t + 1 if t goes in
constexpr int THREADS = 64;    // warp 0 factors, warp 1 owns the slots
constexpr int BLOCKS_PER_SM = 16;  // 2,112 agents at once on 132 SMs
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
  const bool by_value = v < w || (v == w && i < j);
  return (vn || wn) ? vn && (!wn || i < j) : by_value;
}

struct Slot {
  float v;
  int i;
};

__device__ __forceinline__ Slot first(Slot a, Slot b) {
  return precedes(a.v, a.i, b.v, b.i) ? a : b;
}

// A key whose unsigned order is jnp.argmin's order of the scores: NaN
// first, -0 and +0 equal, then the float order.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  const unsigned k = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return v != v ? 0u : (v == 0.0f ? 0x80000000u : k);
}

// The warp's lowest of the lanes' slots (jnp.argmin order: key, then the
// lower index) by two redux.sync minima; the winning lane's score comes by
// shuffle. {inf, N} stands for no slot.
__device__ __forceinline__ Slot warp_min(Slot mine) {
  const unsigned key = order_key(mine.v);
  const unsigned kmin = __reduce_min_sync(FULL, key);
  const int i = static_cast<int>(__reduce_min_sync(
      FULL, key == kmin ? static_cast<unsigned>(mine.i) : 0xffffffffu));
  return {__shfl_sync(FULL, mine.v, i & 31), i};
}

// The three lowest slot scores, in jnp.argmin order (one warp): each lane
// sorts its own three lowest, then three warp minima each take the head of
// one lane's list.
struct Top3 {
  Slot s[3];
};

__device__ __forceinline__ Top3 lowest3(const float* sc, int N, int lane) {
  Top3 own = {{{INFINITY, N}, {INFINITY, N}, {INFINITY, N}}};
  for (int j = lane; j < N; j += 32) {
    const Slot x = {sc[j], j};
    const bool l0 = precedes(x.v, x.i, own.s[0].v, own.s[0].i);
    const bool l1 = precedes(x.v, x.i, own.s[1].v, own.s[1].i);
    const bool l2 = precedes(x.v, x.i, own.s[2].v, own.s[2].i);
    own.s[2] = l1 ? own.s[1] : (l2 ? x : own.s[2]);
    own.s[1] = l0 ? own.s[0] : (l1 ? x : own.s[1]);
    own.s[0] = l0 ? x : own.s[0];
  }
  Top3 top;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    top.s[k] = warp_min(own.s[0]);
    if (top.s[k].i == own.s[0].i) {    // the winner's lane moves on
      own.s[0] = own.s[1];
      own.s[1] = own.s[2];
    }
  }
  return top;
}

// What the two warps hand each other for a pair of candidates.
struct Exchange {
  float dm[STATES];   // Mahalanobis distances (warp 0)
  float kl[STATES];   // clipped KLs (warp 1)
  Top3 top;           // the three lowest slot scores before the pair
};

__device__ __forceinline__ bool pow2(int m) { return (m & (m - 1)) == 0; }

// x / n, as a product with 1/n where n is a power of two (POW2)
template <bool POW2>
__device__ __forceinline__ float over(float x, float n, float inv) {
  return POW2 ? x * inv : x / n;
}

// dst[0, n) = src[0, n) by NT threads, in 16-byte words where both sides
// allow it (no alignment is assumed of the caller's tensors).
template <int NT>
__device__ __forceinline__ void copy(float* dst, const float* src, int n,
                                     int tid) {
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) &
       15) == 0) {
    const int n4 = n >> 2;
#pragma unroll 4
    for (int i = tid; i < n4; i += NT)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    for (int i = (n4 << 2) + tid; i < n; i += NT) dst[i] = src[i];
  } else {
#pragma unroll 4
    for (int i = tid; i < n; i += NT) dst[i] = src[i];
  }
}

// The same from global into shared memory with cp.async, so that every
// load of the agent is in flight at once; cp_async_wait() ends them.
template <int NT>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n, int tid) {
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int tail = 0;
  if (((base | static_cast<unsigned>(reinterpret_cast<size_t>(src))) & 15) ==
      0) {
    for (int i = tid; i < (n >> 2); i += NT)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       base + 16u * i),
                   "l"(src + 4 * i));
    tail = (n >> 2) << 2;
  }
  for (int i = tail + tid; i < n; i += NT)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     base + 4u * i),
                 "l"(src + i));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Warp 0, lane L: the means (lane 8h + j: mu[j] of state h), the
// covariance entries L and L + 32 of the three states into cov[h][64], and
// b = s[h] - mu into bvec[h][8]. so[h][k], ssh[h]: the lane's s_outer
// entries and s_sum[L % 8] in state h, which divides by n[h] (inv[h]: its
// inverse, used where n[h] is a power of two).
template <bool POW2>
__device__ __forceinline__ void covariances(
    const float (&so)[STATES][2], const float (&ssh)[STATES],
    const float (&n)[STATES], const float (&inv)[STATES],
    const float* const (&s)[STATES], float ridge, int lane, float* cov,
    float* bvec) {
  const int h = lane >> 3, j = lane & 7;
  const int e_i = lane / D, e_j = lane % D;
  const float a0 = __shfl_sync(FULL, ssh[0], j);
  const float a1 = __shfl_sync(FULL, ssh[1], j);
  const float a2 = __shfl_sync(FULL, ssh[2], j);
  const float mu = over<POW2>(h == 2 ? a2 : (h == 1 ? a1 : a0),
                             h == 2 ? n[2] : (h == 1 ? n[1] : n[0]),
                             h == 2 ? inv[2] : (h == 1 ? inv[1] : inv[0]));
  const float* sh = h == 2 ? s[2] : (h == 1 ? s[1] : s[0]);
  if (h < STATES) bvec[h * D + j] = sh[j] - mu;
#pragma unroll
  for (int g = 0; g < STATES; ++g) {
    const float mu_j = __shfl_sync(FULL, mu, g * D + e_j);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int row = e_i + 4 * k;
      const float mu_i = __shfl_sync(FULL, mu, g * D + row);
      cov[g * D * D + lane + 32 * k] =
          (over<POW2>(so[g][k], n[g], inv[g]) - mu_i * mu_j) +
          (row == e_j ? ridge : 0.0f);
    }
  }
}

// Warp 0: three factors in the same instructions. Lane 9g + rl is row rl of
// factor g (lanes past 26 shadow lane 0): rows 0..D-1 of the covariance
// cov[g], row D the forward solve of bvec[g]. Returns |y|^2 on row D.
// After column j every lane adds its term k = j to the sums of the columns
// to come (lane i, column c: l[i][j] * l[c][j]) and to the diagonal sums
// (l[c][j] * l[c][j]), so every lane forms l[c][c] itself, each sum still
// runs over k left to right, and column c waits only for one shuffle of
// its last term.
__device__ __forceinline__ float factor3(const float* cov, const float* bvec,
                                         int g, int rl) {
  float r[D], acc[D], cc[D], dg[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    r[j] = rl == D ? bvec[g * D + j] : cov[g * D * D + rl * D + j];
    cc[j] = cov[g * D * D + j * ROWS];      // c[j][j]
    acc[j] = 0.0f;
    dg[j] = 0.0f;
  }
  float dm2 = 0.0f;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float ljj = sqrtf(nan_max(cc[j] - dg[j], 1e-12f));
    const float below = (r[j] - acc[j]) / ljj;
    r[j] = rl == j ? ljj : (rl > j ? below : r[j]);
#pragma unroll
    for (int c = j + 1; c < D; ++c) {
      const float v = __shfl_sync(FULL, r[j], g * ROWS + c);  // l[c][j]
      acc[c] = acc[c] + r[j] * v;
      dg[c] = dg[c] + v * v;
    }
    dm2 = dm2 + r[j] * r[j];                  // |y|^2 on row D
  }
  return dm2;
}

// Warp 1: the clipped-KL term of one action probability.
template <bool POW2>
__device__ __forceinline__ float kl_term(float p, float psum, int nfill,
                                         float n, float inv) {
  const float mp = nfill > 0 ? over<POW2>(psum, n, inv) : p;
  const float pc = nan_clip(p, 1e-8f, 1.0f);
  const float qc = nan_clip(mp, 1e-8f, 1.0f);
  return pc * logf(pc / qc);
}

// Warp 1: p_sum if t stays out / goes in (psx), and the KL terms of t and
// of t + 1 in both cases (kt[3][NA]); op: the probs of the slot t would
// take, sub: 1 if that slot is filled.
template <bool POW2>
__device__ __forceinline__ void kl_terms(const float* ps, const float* p0,
                                         const float* p1, const float* op,
                                         float sub, int nfill, float n0,
                                         int nfill_in, float n2, int NA,
                                         int lane, float* psx, float* kt) {
  const float inv0 = POW2 ? 1.0f / n0 : 0.0f;
  const float inv2 = POW2 ? 1.0f / n2 : 0.0f;
  for (int k = lane; k < NA; k += 32) {
    const float y = ps[k];
    const float stay = y + 0.0f * p0[k] - 0.0f * op[k];
    const float in = y + 1.0f * p0[k] - sub * op[k];
    psx[k] = stay;
    psx[NA + k] = in;
    kt[k] = kl_term<POW2>(p0[k], y, nfill, n0, inv0);
    kt[NA + k] = kl_term<POW2>(p1[k], stay, nfill, n0, inv0);
    kt[2 * NA + k] = kl_term<POW2>(p1[k], in, nfill_in, n2, inv2);
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
diversity_insert_kernel(
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
  extern __shared__ __align__(16) float smem[];
  __shared__ Exchange xs[2];           // by the parity of the pair
  const int a = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* st = smem;                    // N*D   slot states (warp 0)
  float* pr = st + N * D;              // N*NA  slot probs (warp 1)
  float* sc = pr + N * NA;             // N     slot scores (warp 1)
  float* cs = sc + N;                  // T*D   candidate states
  float* cp = cs + T * D;              // T*NA  candidate probs
  float* cov = cp + T * NA;            // 3*D*D covariances (warp 0)
  float* bvec = cov + STATES * D * D;  // 3*D   s - mu (warp 0)
  float* ps = bvec + STATES * D;       // NA    p_sum (warp 1)
  float* psx = ps + NA;                // 2*NA  p_sum if t stays out / in
  float* kt = psx + 2 * NA;            // 3*NA  KL terms (warp 1)
  float* tr_d = kt + STATES * NA;      // T     trace: d (warp 1)
  int* tr_slot = reinterpret_cast<int*>(tr_d + T);  // T slot (warp 1)
  bool* tr_do = reinterpret_cast<bool*>(tr_slot + T);  // T insert (warp 1)
  bool* fl = tr_do + T;                // N     filled (warp 1)

  K1_MARK_START();
  // load: slots and candidates into shared memory (both warps)
  copy_async<THREADS>(st, states + (size_t)a * N * D, N * D, tid);
  copy_async<THREADS>(pr, probs + (size_t)a * N * NA, N * NA, tid);
  copy_async<THREADS>(sc, score + (size_t)a * N, N, tid);
  copy_async<THREADS>(cs, cand_states + (size_t)a * T * D, T * D, tid);
  copy_async<THREADS>(cp, cand_probs + (size_t)a * T * NA, T * NA, tid);
  for (int i = tid; i < N; i += THREADS) fl[i] = filled[(size_t)a * N + i];
  for (int i = tid; i < NA; i += THREADS) ps[i] = p_sum[(size_t)a * NA + i];
  // Warp 0's registers: lane L holds s_outer entries L and L + 32 (rows
  // L/8 and L/8 + 4, column L%8) and s_sum[L%8]. A factor's lane: group g
  // (the state), row rl; lanes past 26 shadow lane 0 (the same values, so
  // no slow path of a division runs on data no one reads).
  const int e_i = lane / D, e_j = lane % D;
  const int g = lane < STATES * ROWS ? lane / ROWS : 0;
  const int rl = lane < STATES * ROWS ? lane % ROWS : 0;
  float so0 = 0.0f, so1 = 0.0f, ssj = 0.0f;
  if (warp == 0) {
    so0 = s_outer[(size_t)a * D * D + lane];
    so1 = s_outer[(size_t)a * D * D + lane + 32];
    ssj = s_sum[(size_t)a * D + e_j];
  }
  int nfill = n_filled[a];
  cp_async_wait();
  __syncthreads();

  K1_MARK(LOAD);
  // warp 0: the slot candidate t would take (after the first pair it comes
  // from warp 1's three lowest scores and the pair's decisions)
  Slot cur = {INFINITY, N};
  for (int j = lane; j < N; j += 32) cur = first({sc[j], j}, cur);
  cur = warp_min(cur);

  K1_MARK(ARGMIN);
  for (int t = 0; t < T; t += 2) {
    Exchange& out = xs[(t >> 1) & 1];
    const bool pair = t + 1 < T;
    const int t1 = pair ? t + 1 : t;    // with no t + 1, a copy of t
    const float* s0 = cs + t * D;
    const float* s1 = cs + t1 * D;
    const float* p0 = cp + t * NA;
    const float* p1 = cp + t1 * NA;
    const float n0 = nan_max(static_cast<float>(nfill), 1.0f);
    if (warp == 0) {
      // mean and covariance of the three states: today's, and t's update
      // with t staying out (add = sub = 0) or going in (add = 1)
      const float sub = cur.v != -INFINITY ? 1.0f : 0.0f;
      const float* o = st + cur.i * D;
      const float sj = s0[e_j], oj = o[e_j];
      float so[STATES][2], ssh[STATES];
      so[0][0] = so0;
      so[0][1] = so1;
      ssh[0] = ssj;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float si = s0[e_i + 4 * k], oi = o[e_i + 4 * k];
        const float y = k ? so1 : so0;
        so[1][k] = y + 0.0f * (si * sj) - 0.0f * (oi * oj);
        so[2][k] = y + 1.0f * (si * sj) - sub * (oi * oj);
      }
      ssh[1] = ssj + 0.0f * sj - 0.0f * oj;
      ssh[2] = ssj + 1.0f * sj - sub * oj;
      const int nfill_in = nfill + 1 - (cur.v != -INFINITY ? 1 : 0);
      const float n2 = nan_max(static_cast<float>(nfill_in), 1.0f);
      const float n[STATES] = {n0, n0, n2};
      const float inv[STATES] = {1.0f / n0, 1.0f / n0, 1.0f / n2};
      const float* const sv[STATES] = {s0, s1, s1};
      if (pow2(max(nfill, 1)) && pow2(max(nfill_in, 1)))
        covariances<true>(so, ssh, n, inv, sv, ridge, lane, cov, bvec);
      else
        covariances<false>(so, ssh, n, inv, sv, ridge, lane, cov, bvec);
      __syncwarp();
      K1_MARK(MEAN_COV);
      // Cholesky, column by column; row D is the forward solve
      const float dm2 = factor3(cov, bvec, g, rl);
      K1_MARK(CHOLESKY);
      // norm of y (row D of each factor)
      if (rl == D && lane < STATES * ROWS)
        out.dm[g] = sqrtf(nan_max(dm2, 0.0f));
      K1_MARK(SOLVE_NORM);
    } else {
      // the three lowest slot scores
      const Top3 top = lowest3(sc, N, lane);
      K1_MARK(ARGMIN);
      // clipped KL of t, and of t + 1 with t staying out or going in
      const Slot b = top.s[0];
      const float sub = b.v != -INFINITY ? 1.0f : 0.0f;
      const int nfill_in = nfill + 1 - (b.v != -INFINITY ? 1 : 0);
      const float n2 = nan_max(static_cast<float>(nfill_in), 1.0f);
      const float* op = pr + b.i * NA;
      if (pow2(max(nfill, 1)) && pow2(max(nfill_in, 1)))
        kl_terms<true>(ps, p0, p1, op, sub, nfill, n0, nfill_in, n2, NA,
                       lane, psx, kt);
      else
        kl_terms<false>(ps, p0, p1, op, sub, nfill, n0, nfill_in, n2, NA,
                        lane, psx, kt);
      __syncwarp();
      float kl0 = 0.0f, kl1 = 0.0f, kl2 = 0.0f;
      for (int k = 0; k < NA; ++k) {
        kl0 = kl0 + kt[k];
        kl1 = kl1 + kt[NA + k];
        kl2 = kl2 + kt[2 * NA + k];
      }
      K1_MARK(KL);
      if (lane == 0) {
        out.kl[0] = kl0;
        out.kl[1] = kl1;
        out.kl[2] = kl2;
        out.top = top;
      }
    }
    // exchange
    __syncthreads();
    K1_MARK(EXCHANGE);
    // decide t, then t + 1 on the state t leaves (both warps alike)
    const Exchange x = out;
    const Slot b = x.top.s[0];
    const float d0 = alpha * x.dm[0] + beta * x.kl[0];
    const bool in0 = d0 > b.v;                     // -inf (empty) accepts
    const bool ev0 = in0 && (b.v != -INFINITY);
    const Slot m1 = in0 ? first({d0, b.i}, x.top.s[1]) : b;
    const int h = in0 ? 2 : 1;
    const float d1 = alpha * x.dm[h] + beta * x.kl[h];
    const bool in1 = pair && d1 > m1.v;
    const bool ev1 = in1 && (m1.v != -INFINITY);
    const float add1 = in1 ? 1.0f : 0.0f;
    const float sub1 = ev1 ? 1.0f : 0.0f;

    // update: t's insert (the state picked above), then t + 1's
    if (warp == 0) {
      const float sub = b.v != -INFINITY ? 1.0f : 0.0f;
      const float* o = st + b.i * D;
      const float sj = s0[e_j], oj = o[e_j];
      const float si0 = s0[e_i], oi0 = o[e_i];
      const float si1 = s0[e_i + 4], oi1 = o[e_i + 4];
      if (in0) {
        so0 = so0 + 1.0f * (si0 * sj) - sub * (oi0 * oj);
        so1 = so1 + 1.0f * (si1 * sj) - sub * (oi1 * oj);
        ssj = ssj + 1.0f * sj - sub * oj;
      } else {
        so0 = so0 + 0.0f * (si0 * sj) - 0.0f * (oi0 * oj);
        so1 = so1 + 0.0f * (si1 * sj) - 0.0f * (oi1 * oj);
        ssj = ssj + 0.0f * sj - 0.0f * oj;
      }
      __syncwarp();  // every lane has read the old occupant before it goes
      if (in0 && lane < D) st[b.i * D + lane] = s0[lane];
      if (pair) {
        __syncwarp();
        const float* o1 = st + m1.i * D;
        const float tj = s1[e_j], qj = o1[e_j];
        so0 = so0 + add1 * (s1[e_i] * tj) - sub1 * (o1[e_i] * qj);
        so1 = so1 + add1 * (s1[e_i + 4] * tj) - sub1 * (o1[e_i + 4] * qj);
        ssj = ssj + add1 * tj - sub1 * qj;
        __syncwarp();
        if (in1 && lane < D) st[m1.i * D + lane] = s1[lane];
      }
      K1_MARK(UPDATE);
      // the next pair's slot: the new scores of the (at most two) slots
      // that changed, or the lowest old score among the others
      cur = {INFINITY, N};
      if (in0 && !(in1 && m1.i == b.i)) cur = first({d0, b.i}, cur);
      if (in1) cur = first({d1, m1.i}, cur);
      bool kept = false;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const Slot o3 = x.top.s[k];
        const bool gone = (in0 && o3.i == b.i) || (in1 && o3.i == m1.i);
        if (!kept && !gone) cur = first(o3, cur);
        kept = kept || !gone;
      }
      K1_MARK(ARGMIN);
    } else {
      for (int k = lane; k < NA; k += 32) ps[k] = psx[(in0 ? NA : 0) + k];
      __syncwarp();
      if (in0)
        for (int k = lane; k < NA; k += 32) pr[b.i * NA + k] = p0[k];
      if (lane == 0) {
        if (in0) {
          sc[b.i] = d0;
          fl[b.i] = true;
        }
        tr_slot[t] = b.i;
        tr_do[t] = in0;
        tr_d[t] = d0;
      }
      if (pair) {
        __syncwarp();
        const float* op = pr + m1.i * NA;
        for (int k = lane; k < NA; k += 32)
          ps[k] = ps[k] + add1 * p1[k] - sub1 * op[k];
        __syncwarp();
        if (in1)
          for (int k = lane; k < NA; k += 32) pr[m1.i * NA + k] = p1[k];
        if (lane == 0) {
          if (in1) {
            sc[m1.i] = d1;
            fl[m1.i] = true;
          }
          tr_slot[t1] = m1.i;
          tr_do[t1] = in1;
          tr_d[t1] = d1;
        }
      }
      __syncwarp();
    }
    K1_MARK(UPDATE);
    nfill = nfill + (in0 ? 1 : 0) - (ev0 ? 1 : 0);
    nfill = nfill + (in1 ? 1 : 0) - (ev1 ? 1 : 0);
  }

  // store (both warps)
  __syncthreads();
  copy<THREADS>(o_states + (size_t)a * N * D, st, N * D, tid);
  copy<THREADS>(o_probs + (size_t)a * N * NA, pr, N * NA, tid);
  copy<THREADS>(o_score + (size_t)a * N, sc, N, tid);
  for (int i = tid; i < N; i += THREADS) o_filled[(size_t)a * N + i] = fl[i];
  for (int i = tid; i < NA; i += THREADS) o_psum[(size_t)a * NA + i] = ps[i];
  for (int i = tid; i < T; i += THREADS) {
    o_slot[(size_t)a * T + i] = tr_slot[i];
    o_do[(size_t)a * T + i] = tr_do[i];
    o_d[(size_t)a * T + i] = tr_d[i];
  }
  if (warp == 0) {
    o_souter[(size_t)a * D * D + lane] = so0;
    o_souter[(size_t)a * D * D + lane + 32] = so1;
    if (lane < D) o_ssum[(size_t)a * D + lane] = ssj;
  }
  if (tid == 0) o_nfill[a] = nfill;
  K1_MARK(STORE);
  K1_MARK_END();
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
      sizeof(float) * (size_t)(N * D + N * NA + N + T * D + T * NA +
                               STATES * D * D + STATES * D + 6 * NA + 2 * T) +
      sizeof(bool) * (size_t)(T + N);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        diversity_insert_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  diversity_insert_kernel<<<A, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      states, probs, score, filled, s_sum, s_outer, p_sum, n_filled,
      cand_states, cand_probs, o_states, o_probs, o_score, o_filled, o_ssum,
      o_souter, o_psum, o_nfill, o_slot, o_do, o_d, N, NA, T, alpha, beta,
      ridge);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* diversity_insert_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
