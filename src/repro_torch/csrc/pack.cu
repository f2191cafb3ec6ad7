// K6 pack: the frame/token packing row gather, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/packing.py:34 (pack, body
// _pack_kernel :21). Plain version: repro_torch/kernels/ref.py::pack_ref.
//
// out[i] = tokens[min(indices[i], T - 1)] for indices[i] >= 0, a zero row
// for indices[i] < 0. The rows are copied as raw bytes, so any element type
// (float32, bf16, int32, ...) is copied bit for bit. One block of 128
// threads per output row (grid-stride over rows): each thread reads the
// row's index once and copies 16-, 4- or 1-byte words, the widest that the
// row size and the pointers' alignment allow.
//
// Bound: by bytes. N rows written, the rows of non-negative indices read
// once, and the N int32 indices: at T=4096, D=896 float32, N=8192 with
// ~10 % padding, 55.9 MB, 16.7 us at 3.35 TB/s. The TPU kernel's scalar
// prefetch of the indices becomes one index load per block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

template <typename W>
__global__ void __launch_bounds__(THREADS) pack_kernel(
    const W* __restrict__ tokens, const int* __restrict__ indices,
    W* __restrict__ out, int T, int N, long long row_words) {
  for (int i = blockIdx.x; i < N; i += gridDim.x) {
    const int idx = indices[i];
    W* dst = out + static_cast<long long>(i) * row_words;
    if (idx < 0) {
      for (long long w = threadIdx.x; w < row_words; w += THREADS)
        dst[w] = W{};
    } else {
      const W* src = tokens + static_cast<long long>(min(idx, T - 1)) *
                                  row_words;
      for (long long w = threadIdx.x; w < row_words; w += THREADS)
        dst[w] = src[w];
    }
  }
}

template <typename W>
int launch(const void* tokens, const int* indices, void* out, int T, int N,
           long long row_bytes, cudaStream_t stream) {
  const int grid = N < 65535 ? N : 65535;
  pack_kernel<W><<<grid, THREADS, 0, stream>>>(
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
