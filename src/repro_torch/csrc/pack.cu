// K6 pack: the frame/token packing row gather, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/packing.py:34 (pack, body
// _pack_kernel :21). Plain version: repro_torch/kernels/ref.py::pack_ref.
//
// out[i] = tokens[min(indices[i], T - 1)] for indices[i] >= 0, a zero row
// for indices[i] < 0. The rows are copied as raw bytes, so any element type
// (float32, bf16, int32, ...) is copied bit for bit, in 16-, 4- or 1-byte
// words, the widest that the row size and the pointers' alignment allow.
//
// Design. One warp per output row, eight rows per block, and a grid of at
// most as many blocks as the card holds at once (warp-strided over the
// rows beyond that). A warp reads the indices of its next 32 rows with one
// load (lane r holds row r's) and broadcasts each with a shuffle, so no
// row waits on its own index load. Each lane then issues all of its loads
// of a row (up to 8 words, 7 of 16 bytes at D=896 float32, 3-4 at bf16)
// before the first store. Stores are plain: the streaming hint (__stcs)
// was faster from a table left in L2 but slower from cold tables, and the
// caller reads the bucket next, which an evict-first store pushes out of
// L2. A padding row is written as zeros and reads nothing.
//
// Bound: by bytes. N rows written, each distinct row of a non-negative
// index read once (a repeated index may be served by L2 within a call),
// and the N int32 indices: at T=4096, D=896 float32, N=8192 with ~10 %
// padding drawn uniformly, ~3,480 distinct rows, 41.9 MB, 12.5 us at
// 3.35 TB/s from a cold table. What sets the time is HBM: the 29.4 MB
// bucket written and the distinct rows read. Every warp holds one row at
// that size, so the reads come first and the writes last, and a call that
// follows another overlaps its reads with the earlier call's write-back.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;              // rows in flight per block
constexpr int THREADS = 32 * WARPS;
constexpr int UNROLL = 8;             // words a lane loads before it stores
constexpr unsigned FULL = 0xffffffffu;

template <typename W>
__global__ void __launch_bounds__(THREADS) pack_kernel(
    const W* __restrict__ tokens, const int* __restrict__ indices,
    W* __restrict__ out, int T, int N, long long row_words) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * WARPS;
  const long long first = static_cast<long long>(blockIdx.x) * WARPS +
                          (threadIdx.x >> 5);
  for (long long base = first; base < N; base += 32 * n_warps) {
    const long long mine = base + lane * n_warps;
    const int my_idx = mine < N ? indices[mine] : -1;
    for (int r = 0; r < 32; ++r) {
      const long long row = base + r * n_warps;
      if (row >= N) break;                        // the same for all lanes
      const int idx = __shfl_sync(FULL, my_idx, r);
      W* dst = out + row * row_words;
      if (idx < 0) {
        for (long long w = lane; w < row_words; w += 32)
          dst[w] = W{};
        continue;
      }
      const W* src = tokens + static_cast<long long>(min(idx, T - 1)) *
                                  row_words;
      for (long long w0 = lane; w0 < row_words; w0 += 32 * UNROLL) {
        W v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (w0 + 32 * u < row_words) v[u] = src[w0 + 32 * u];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (w0 + 32 * u < row_words) dst[w0 + 32 * u] = v[u];
      }
    }
  }
}

// Blocks of pack_kernel<W> the card holds at once (queried once).
template <typename W>
cudaError_t resident_blocks(int* blocks) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pack_kernel<W>, THREADS, 0);
    if (e != cudaSuccess) return e;
    cached = sms * per_sm;
  }
  *blocks = cached;
  return cudaSuccess;
}

template <typename W>
int launch(const void* tokens, const int* indices, void* out, int T, int N,
           long long row_bytes, cudaStream_t stream) {
  int most = 0;
  const cudaError_t e = resident_blocks<W>(&most);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int need = (N + WARPS - 1) / WARPS;
  pack_kernel<W><<<need < most ? need : most, THREADS, 0, stream>>>(
      static_cast<const W*>(tokens), indices, static_cast<W*>(out), T, N,
      row_bytes / static_cast<long long>(sizeof(W)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pack_launch(const void* tokens, const int* indices, void* out,
                           int T, int N, long long row_bytes, void* stream) {
  if (T <= 0 || N < 0 || row_bytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(tokens) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0)
    return launch<uint4>(tokens, indices, out, T, N, row_bytes, s);
  if (align % 4 == 0)
    return launch<uint32_t>(tokens, indices, out, T, N, row_bytes, s);
  return launch<unsigned char>(tokens, indices, out, T, N, row_bytes, s);
}

extern "C" const char* pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
