// K3 queue_advance: K microticks of the request-level twin's data plane,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/queue_advance.py:50
// (queue_advance -> _queue_kernel). Plain version:
// repro_torch/kernels/ref.py::queue_advance_ref over sim_microtick.
//
// One warp per agent. The agent's arrival ring (R int32) and latency
// histogram (H int32) live in dynamic shared memory for all K ticks; the 12
// counters, 2 credits and the latency sum live in registers, computed by
// every lane redundantly (no broadcast needed). Per tick the stage scalars
// are a handful of integer ops; only two ring segments need lanes:
//   - the completed segment, n_post slots from head: each lane sums the
//     latencies and effective completions of its slots (warp-reduced; int32
//     sums are order-free, so the bits match the plain version) and adds
//     them to the histogram by shared-memory atomicAdd (exact for integers);
//   - the admitted segment, admit slots from tail: the lanes stamp the tick.
// Completed slots are read before admitted slots are written (the ring may
// wrap onto slots completed in the same tick), with __syncwarp between.
// Out of place, as the TPU kernel is: the caller reads the old counters
// after the advance.
//
// Bound: by bytes, 2,468 B read + 2,364 B written per agent at R=512, H=64,
// K=20, so 0.0115 us at A=8 and 2.95 us at A=2048 over 3.35 TB/s. The chain
// of K dependent ticks with shared-memory latency on the critical path sets
// the time instead; several agents per block and fusing the caps decode and
// arrival spreading into the launch are later work.
//
// Numerics: built with -fmad=false and no fast math. Credits are
// min(credit + c, c + 1) - (float)n in float32, with jnp.minimum's NaN
// propagation; float->int casts truncate; every other quantity is int32
// with two's-complement wrap, so the result is bit-identical to the plain
// version and the JAX oracle.
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;
enum {
  TAIL, PPRE, LAUNCH, PINF, HEAD, BUSY, DONE_AT, ARRIVED, DROPPED, COMPLETED,
  EFFECTIVE, TICK, NCOUNTERS
};
enum { CAP_PRE, CAP_POST, CAP_BATCH, CAP_TBATCH, CAP_QCAP, CAP_SLO, NCAPS };

// jnp.minimum / torch.minimum: NaN propagates (fminf would drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__global__ void __launch_bounds__(LANES) queue_advance_kernel(
    const int* __restrict__ arrive, const int* __restrict__ counters,
    const float* __restrict__ credits, const float* __restrict__ lat_sum,
    const int* __restrict__ hist, const int* __restrict__ arrivals,
    const float* __restrict__ caps, int* __restrict__ o_arrive,
    int* __restrict__ o_counters, float* __restrict__ o_credits,
    float* __restrict__ o_lat_sum, int* __restrict__ o_hist, int R, int H,
    int K) {
  extern __shared__ int smem[];
  int* ring = smem;
  int* hs = smem + R;
  const size_t agent = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned rmask = static_cast<unsigned>(R - 1);

  for (int i = lane; i < R; i += LANES) ring[i] = arrive[agent * R + i];
  for (int i = lane; i < H; i += LANES) hs[i] = hist[agent * H + i];
  int c[NCOUNTERS];
#pragma unroll
  for (int j = 0; j < NCOUNTERS; ++j) c[j] = counters[agent * NCOUNTERS + j];
  float cr_pre = credits[agent * 2], cr_post = credits[agent * 2 + 1];
  float ls = lat_sum[agent];
  const float* cp = caps + agent * NCAPS;
  const float c_pre = cp[CAP_PRE], c_post = cp[CAP_POST];
  const int batch_slots = static_cast<int>(cp[CAP_BATCH]);
  const int t_batch = static_cast<int>(cp[CAP_TBATCH]);
  const int qcap = static_cast<int>(cp[CAP_QCAP]);
  const int slo = static_cast<int>(cp[CAP_SLO]);
  const int* arr = arrivals + agent * K;
  __syncwarp();

  for (int t = 0; t < K; ++t) {
    const int n_arr = arr[t];
    const int m = c[TICK];

    // (1) inference completion
    const bool done = c[BUSY] > 0 && m >= c[DONE_AT];
    const int p_inf = done ? c[LAUNCH] : c[PINF];
    int busy = done ? 0 : c[BUSY];

    // (2) post service: the n_post oldest post-queue slots complete
    float post_credit = nan_min(cr_post + c_post, c_post + 1.0f);
    const int n_post = min(static_cast<int>(post_credit), p_inf - c[HEAD]);
    post_credit = post_credit - static_cast<float>(n_post);
    const int n_comp = min(n_post, R);  // slots with offset < n_post
    int lsum = 0, neff = 0;
    for (int j = lane; j < n_comp; j += LANES) {
      const int lat = m + 1 - ring[(static_cast<unsigned>(c[HEAD]) + j) & rmask];
      lsum += lat;
      neff += lat <= slo;
      atomicAdd(&hs[lat < 0 ? 0 : (lat > H - 1 ? H - 1 : lat)], 1);
    }
    lsum = warp_sum(lsum);
    neff = warp_sum(neff);
    ls = ls + static_cast<float>(lsum);
    const int head = c[HEAD] + n_post;

    // (3) batch launch, backpressured by post-queue room
    const int ready = c[PPRE] - c[LAUNCH];
    const int room = qcap - (c[LAUNCH] - head);
    const int n_launch = max(min(min(ready, batch_slots), room), 0);
    const bool do_launch = busy == 0 && n_launch > 0;
    const int launch = do_launch ? c[LAUNCH] + n_launch : c[LAUNCH];
    const int done_at = do_launch ? m + t_batch : c[DONE_AT];
    busy = do_launch ? 1 : busy;

    // (4) pre service, backpressured by batch-queue room
    float pre_credit = nan_min(cr_pre + c_pre, c_pre + 1.0f);
    int n_pre = min(static_cast<int>(pre_credit),
                    min(c[TAIL] - c[PPRE], max(qcap - (c[PPRE] - launch), 0)));
    n_pre = max(n_pre, 0);
    pre_credit = pre_credit - static_cast<float>(n_pre);
    const int p_pre = c[PPRE] + n_pre;

    // (5) admission; overflow drops
    const int free_slots = min(qcap - (c[TAIL] - p_pre), R - (c[TAIL] - head));
    const int admit = min(max(min(n_arr, free_slots), 0), n_arr);
    const int n_adm = min(admit, R);
    __syncwarp();  // completed slots are read before admission rewrites them
    for (int j = lane; j < n_adm; j += LANES)
      ring[(static_cast<unsigned>(c[TAIL]) + j) & rmask] = m;
    __syncwarp();  // the next tick reads what other lanes wrote

    c[TAIL] = c[TAIL] + admit;
    c[PPRE] = p_pre;
    c[LAUNCH] = launch;
    c[PINF] = p_inf;
    c[HEAD] = head;
    c[BUSY] = busy;
    c[DONE_AT] = done_at;
    c[ARRIVED] = c[ARRIVED] + n_arr;
    c[DROPPED] = c[DROPPED] + (n_arr - admit);
    c[COMPLETED] = c[COMPLETED] + n_post;
    c[EFFECTIVE] = c[EFFECTIVE] + neff;
    c[TICK] = m + 1;
    cr_pre = pre_credit;
    cr_post = post_credit;
  }

  for (int i = lane; i < R; i += LANES) o_arrive[agent * R + i] = ring[i];
  for (int i = lane; i < H; i += LANES) o_hist[agent * H + i] = hs[i];
#pragma unroll
  for (int j = 0; j < NCOUNTERS; ++j)
    if (lane == j) o_counters[agent * NCOUNTERS + j] = c[j];
  if (lane == 0) {
    o_credits[agent * 2] = cr_pre;
    o_credits[agent * 2 + 1] = cr_post;
    o_lat_sum[agent] = ls;
  }
}

}  // namespace

extern "C" int queue_advance_launch(
    const int* arrive, const int* counters, const float* credits,
    const float* lat_sum, const int* hist, const int* arrivals,
    const float* caps, int* o_arrive, int* o_counters, float* o_credits,
    float* o_lat_sum, int* o_hist, int A, int R, int H, int K, void* stream) {
  if (A <= 0 || R <= 0 || (R & (R - 1)) != 0 || H < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(R) + H) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        queue_advance_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  queue_advance_kernel<<<A, LANES, smem, static_cast<cudaStream_t>(stream)>>>(
      arrive, counters, credits, lat_sum, hist, arrivals, caps, o_arrive,
      o_counters, o_credits, o_lat_sum, o_hist, R, H, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* queue_advance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
