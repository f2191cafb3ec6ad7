// K2 delta_codec: the FL error-feedback encode/decode, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/delta_codec.py:41
// (delta_codec -> _codec_kernel). Plain version:
// repro_torch/kernels/ref.py::delta_codec_ref, per leaf.
//
// One launch codes every leaf of an FL round (up to MAX_LEAVES; the
// launcher launches once more for each MAX_LEAVES beyond). The leaves'
// pointers, lengths, budgets and a prefix table of their blocks travel in
// one by-value kernel parameter, so the launch needs no host-to-device copy
// and a CUDA graph can capture it. A block finds its leaf in the prefix
// table; then each agent row of L values is coded by one group of threads:
//   L <= 512   a warp (eight rows a block), reductions by shuffle only;
//   L >  512   the block (256 threads), reductions through shared memory.
// A thread holds 16 values of its row in registers (four 16-byte words where
// the row's addresses allow, else scalars), so a group codes 512 or 4,096
// values from one read of each input; a longer row is walked in chunks of
// 4,096 and re-read per pass. Each value xf = delta + residual is formed
// once, and then
//   float32: decoded = xf, residual = 0 (topk with k >= L too);
//   int8:    the row's max of |xf| (NaN propagates), scale = max(m, 1e-12)
//            * (1/127), frac = xf / scale, q = clip(rint(frac), +-127) (half
//            to even), decoded = q * scale, residual = (frac - q) * scale;
//   topk:    keep exactly the k largest |xf|, ties to the lowest index. The
//            registers turn into keys in place, the uint32 bit pattern of
//            |xf| (monotone for non-negative floats; NaN above +inf), with
//            the signs kept in one bitmask. The k-th largest key is found
//            bit by bit from the top, as the largest p with #(keys >= p)
//            >= k: one compare a value and one group sum (redux.sync) a
//            bit, no histogram and no atomics; a count of exactly k ends the
//            search (the k-th largest is then the least key >= p). Then
//            float compares count the values above and equal to it; only
//            when there are more equal values than places does an
//            index-ordered scan take the first ones.
// The kernel is built once per codec, so each keeps its own registers.
//
// Bound: 16 B per value per round (two reads, two writes): 72 KB per agent
// over the 12 leaves of one iAgent, ~148 MB at A=2048, 44.3 us of HBM time
// on an H100 (3.35 TB/s); at A=8 (0.173 us) the one launch and the longest
// row's chain of reductions set the time.
//
// Numerics: built with -fmad=false and IEEE division, so every result is
// bit-identical to the plain PyTorch version and to the JAX oracle.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEAVES = 16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VPT = 16;                  // values a thread holds
constexpr int WARP_ROW_MAX = 32 * VPT;   // rows up to this take one warp
constexpr unsigned FULL = 0xffffffffu;
enum Codec { kFloat32 = 0, kInt8 = 1, kTopk = 2 };

struct Leaves {
  const float* delta[MAX_LEAVES];
  const float* residual[MAX_LEAVES];
  float* dec[MAX_LEAVES];
  float* res[MAX_LEAVES];
  int L[MAX_LEAVES];
  int k[MAX_LEAVES];
  int first_block[MAX_LEAVES + 1];  // leaf i has blocks [first_block[i], [i+1])
  int n, A;
};

// jnp.max / jnp.clip: NaN propagates (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

__device__ __forceinline__ float lane_of(const float4& x, int r) {
  return r == 0 ? x.x : (r == 1 ? x.y : (r == 2 ? x.z : x.w));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += n;
  }
  return v;
}

// The group of threads that codes one row: a warp (G = 32) or the block
// (G = 256). ``red`` is the group's shared scratch, two buffers of WARPS
// words (block only): a reduction writes buffer ``buf`` and needs one
// barrier, so that reductions alternating between the buffers need no
// barrier after the read.
template <int G> struct Group;

template <> struct Group<32> {
  static __device__ int rank() { return threadIdx.x & 31; }
  static __device__ float max(float v, int*) { return warp_max(v); }
  static __device__ int sum(int v, int*, int) { return __reduce_add_sync(FULL, v); }
  static __device__ unsigned min(unsigned v, int*, int) {
    return __reduce_min_sync(FULL, v);
  }
  // exclusive prefix of v in rank order; *total = the group's sum
  static __device__ int scan(int v, int* total, int*, int) {
    const int incl = warp_incl_scan(v);
    *total = __shfl_sync(FULL, incl, 31);
    return incl - v;
  }
};

template <> struct Group<THREADS> {
  static __device__ int rank() { return threadIdx.x; }
  // int8's one reduction a row: buffer 0, no barrier after the read
  static __device__ float max(float v, int* red) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* r = reinterpret_cast<float*>(red);
    v = warp_max(v);
    if (lane == 0) r[warp] = v;
    __syncthreads();
    return warp_max(lane < WARPS ? r[lane] : -INFINITY);
  }
  static __device__ int sum(int v, int* red, int buf) {
    int* r = red + buf * WARPS;
    v = __reduce_add_sync(FULL, v);
    if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += r[w];
    return s;
  }
  static __device__ unsigned min(unsigned v, int* red, int buf) {
    unsigned* r = reinterpret_cast<unsigned*>(red + buf * WARPS);
    v = __reduce_min_sync(FULL, v);
    if ((threadIdx.x & 31) == 0) r[threadIdx.x >> 5] = v;
    __syncthreads();
    unsigned m = r[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = r[w] < m ? r[w] : m;
    return m;
  }
  static __device__ int scan(int v, int* total, int* red, int buf) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int* r = red + buf * WARPS;
    const int incl = warp_incl_scan(v);
    if (lane == 31) r[warp] = incl;
    __syncthreads();
    int before = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int x = r[w];
      before += w < warp ? x : 0;
      sum += x;
    }
    *total = sum;
    return before + incl - v;
  }
};

// Code one row of L values with the group G; red (2 * WARPS words) is the
// group's shared memory.
template <int G, int CODEC>
__device__ void code_row(const float* __restrict__ dl,
                         const float* __restrict__ rs, float* __restrict__ od,
                         float* __restrict__ orr, int L, int k, int* red) {
  using Gp = Group<G>;
  constexpr int CH = G * VPT;  // values a group holds at once
  const int t = Gp::rank();
  const int nch = (L + CH - 1) / CH;
  const bool vec = ((reinterpret_cast<uintptr_t>(dl) | reinterpret_cast<uintptr_t>(rs) |
                     reinterpret_cast<uintptr_t>(od) | reinterpret_cast<uintptr_t>(orr)) &
                    15) == 0;
  // value 4q + r of this thread in chunk ch is element ch*CH + (q*G + t)*4 + r;
  // past L it holds 0 (a key below every candidate of the select)
  float v[VPT];
  auto first = [&](int ch, int q) { return ch * CH + (q * G + t) * 4; };
  // some lane of this thread's warp holds a value of quad q
  auto warp_has = [&](int ch, int q) {
    return ch * CH + (q * G + (t & ~31)) * 4 < L;
  };
  auto load = [&](int ch) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i0 = first(ch, q);
      if (vec && i0 + 3 < L) {
        const float4 a = *reinterpret_cast<const float4*>(dl + i0);
        const float4 b = *reinterpret_cast<const float4*>(rs + i0);
        v[4 * q] = a.x + b.x;
        v[4 * q + 1] = a.y + b.y;
        v[4 * q + 2] = a.z + b.z;
        v[4 * q + 3] = a.w + b.w;
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          v[4 * q + r] = i0 + r < L ? dl[i0 + r] + rs[i0 + r] : 0.0f;
      }
    }
  };
  auto put = [&](int ch, int q, float4 a, float4 b) {
    const int i0 = first(ch, q);
    if (vec && i0 + 3 < L) {
      *reinterpret_cast<float4*>(od + i0) = a;
      *reinterpret_cast<float4*>(orr + i0) = b;
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (i0 + r < L) { od[i0 + r] = lane_of(a, r); orr[i0 + r] = lane_of(b, r); }
    }
  };
  auto quad = [&](int q) {
    return make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  };
  if (nch == 1) load(0);

  if (CODEC == kFloat32 || (CODEC == kTopk && k >= L)) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int ch = 0; ch < nch; ++ch) {
      if (nch > 1) load(ch);
#pragma unroll
      for (int q = 0; q < 4; ++q) put(ch, q, quad(q), zero);
    }
    return;
  }

  if (CODEC == kInt8) {
    float m = -INFINITY;  // padding holds 0, which no |x| falls below
    for (int ch = 0; ch < nch; ++ch) {
      if (nch > 1) load(ch);
#pragma unroll
      for (int j = 0; j < VPT; ++j) m = nan_max(m, fabsf(v[j]));
    }
    m = Gp::max(m, red);
    const float scale = nan_max(m, 1e-12f) * (1.0f / 127.0f);
    for (int ch = 0; ch < nch; ++ch) {
      if (nch > 1) load(ch);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!warp_has(ch, q)) break;
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (first(ch, q) + r >= L) continue;  // no division for padding
          const float frac = v[4 * q + r] / scale;
          float qv = rintf(frac);
          qv = (qv != qv) ? qv : fminf(fmaxf(qv, -127.0f), 127.0f);
          a[r] = qv * scale;
          b[r] = (frac - qv) * scale;
        }
        put(ch, q, make_float4(a[0], a[1], a[2], a[3]),
            make_float4(b[0], b[1], b[2], b[3]));
      }
    }
    return;
  }

  // ---- topk: the select works on keys in place: v[j] becomes the bit
  // pattern of |xf| (as a float, fabsf(xf) exactly) and bit j of ``signs``
  // keeps the sign, so a compare with a key is one instruction ----
  unsigned signs = 0;
  auto to_keys = [&]() {
    signs = 0;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const unsigned bits = __float_as_uint(v[j]);
      signs |= (bits >> 31) << j;
      v[j] = __uint_as_float(bits & 0x7fffffffu);
    }
  };
  auto reload = [&](int ch) {
    if (nch > 1) { load(ch); to_keys(); }
  };
  if (nch == 1) to_keys();

  // the k-th largest key, bit by bit from the top: the largest p with
  // #(keys >= p) >= k. A count of exactly k ends the search early: the
  // k-th largest is then the least key >= p.
  auto count_ge = [&](unsigned p) {
    int n = 0;
    for (int ch = 0; ch < nch; ++ch) {
      reload(ch);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!warp_has(ch, q)) break;
#pragma unroll
        for (int r = 0; r < 4; ++r) n += __float_as_uint(v[4 * q + r]) >= p;
      }
    }
    return n;
  };
  unsigned prefix = 0;
  bool exact = false;
  int buf = 0;
  for (int bit = 30; bit >= 0; --bit) {
    const unsigned cand = prefix | (1u << bit);
    const int n = Gp::sum(count_ge(cand), red, buf);
    buf ^= 1;
    if (n >= k) {
      prefix = cand;
      if (n == k) { exact = true; break; }
    }
  }
  if (exact) {
    unsigned m = 0xffffffffu;
    for (int ch = 0; ch < nch; ++ch) {
      reload(ch);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const unsigned key = __float_as_uint(v[j]);
        m = key >= prefix && key < m ? key : m;
      }
    }
    prefix = Gp::min(m, red, buf);
    buf ^= 1;
  }
  const float thresh = __uint_as_float(prefix);

  // float comparisons from here on, exactly as the reference's mask
  int above = 0, equal = 0;
  for (int ch = 0; ch < nch; ++ch) {
    reload(ch);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const bool in = first(ch, j >> 2) + (j & 3) < L;
      above += in && v[j] > thresh;
      equal += in && v[j] == thresh;
    }
  }
  const int need_eq = k - Gp::sum(above, red, buf);
  buf ^= 1;
  // only where the equal values do not all fit is their index order needed
  const bool ordered = Gp::sum(equal, red, buf) > need_eq;
  buf ^= 1;
  int taken = 0;
  for (int ch = 0; ch < nch; ++ch) {
    if (nch > 1) load(ch);  // xf again; a single chunk rebuilds it from its key
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float xf[4], mag[4];
      bool eq[4];
      int n_eq = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * q + r;
        xf[r] = nch > 1 ? v[j] : __uint_as_float(__float_as_uint(v[j]) |
                                                 ((signs >> j) & 1u) << 31);
        mag[r] = fabsf(xf[r]);
        eq[r] = first(ch, q) + r < L && mag[r] == thresh;
        n_eq += eq[r];
      }
      int before = 0;
      if (ordered) {
        int total;
        before = taken + Gp::scan(n_eq, &total, red, buf);
        buf ^= 1;
        taken += total;
      }
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool keep = mag[r] > thresh || (eq[r] && (!ordered || before < need_eq));
        before += eq[r];
        a[r] = keep ? xf[r] : 0.0f;
        b[r] = keep ? 0.0f : xf[r];
      }
      put(ch, q, make_float4(a[0], a[1], a[2], a[3]),
          make_float4(b[0], b[1], b[2], b[3]));
    }
  }
}

// five blocks an SM (at most 51 registers a thread): topk spills a few words
// but keeps more rows in flight at A=2048
template <int CODEC>
__global__ void __launch_bounds__(THREADS, 5) delta_codec_kernel(
    const __grid_constant__ Leaves p) {
  __shared__ int red[2 * WARPS];
  const int b = blockIdx.x;
  int leaf = 0;
  while (leaf + 1 < p.n && b >= p.first_block[leaf + 1]) ++leaf;
  const int L = p.L[leaf];
  if (L <= WARP_ROW_MAX) {  // eight rows a block, one a warp
    const int row = (b - p.first_block[leaf]) * WARPS + (threadIdx.x >> 5);
    if (row >= p.A) return;
    const size_t off = static_cast<size_t>(row) * L;
    code_row<32, CODEC>(p.delta[leaf] + off, p.residual[leaf] + off,
                        p.dec[leaf] + off, p.res[leaf] + off, L, p.k[leaf],
                        nullptr);
  } else {  // one row a block
    const size_t off = static_cast<size_t>(b - p.first_block[leaf]) * L;
    code_row<THREADS, CODEC>(p.delta[leaf] + off, p.residual[leaf] + off,
                             p.dec[leaf] + off, p.res[leaf] + off, L,
                             p.k[leaf], red);
  }
}

}  // namespace

// Code n leaves of A rows each: leaf i is delta[i], residual[i] (A, L[i])
// into dec[i], res[i], with top-k budget k[i]. One launch per MAX_LEAVES
// leaves, on ``stream``; returns the first CUDA error code, or 0.
extern "C" int delta_codec_launch(const float* const* delta,
                                  const float* const* residual,
                                  float* const* dec, float* const* res,
                                  const int* L, const int* k, int n, int A,
                                  int codec, void* stream) {
  if (n < 1 || A <= 0 || codec < kFloat32 || codec > kTopk)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n; ++i)
    if (L[i] <= 0 || (codec == kTopk && k[i] < 1))
      return static_cast<int>(cudaErrorInvalidValue);
  for (int start = 0; start < n; start += MAX_LEAVES) {
    Leaves p;
    p.n = n - start < MAX_LEAVES ? n - start : MAX_LEAVES;
    p.A = A;
    long long blocks = 0;
    for (int i = 0; i < p.n; ++i) {
      const int j = start + i;
      p.delta[i] = delta[j];
      p.residual[i] = residual[j];
      p.dec[i] = dec[j];
      p.res[i] = res[j];
      p.L[i] = L[j];
      p.k[i] = k[j];
      p.first_block[i] = static_cast<int>(blocks);
      blocks += L[j] <= WARP_ROW_MAX ? (A + WARPS - 1) / WARPS : A;
    }
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    p.first_block[p.n] = static_cast<int>(blocks);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned grid = static_cast<unsigned>(blocks);
    if (codec == kFloat32) delta_codec_kernel<kFloat32><<<grid, THREADS, 0, st>>>(p);
    if (codec == kInt8) delta_codec_kernel<kInt8><<<grid, THREADS, 0, st>>>(p);
    if (codec == kTopk) delta_codec_kernel<kTopk><<<grid, THREADS, 0, st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* delta_codec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
