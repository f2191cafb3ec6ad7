// K3 queue_advance: K microticks of the request-level twin's data plane,
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/queue_advance.py:50
// (queue_advance -> _queue_kernel). Plain version:
// repro_torch/kernels/ref.py::queue_advance_ref over sim_microtick.
//
// Up to 8 agents a block, in two phases. In sim_microtick the 12 counters
// and the two credits depend only on the counters, the caps and the
// arrivals; only the latency sum, the EFFECTIVE counter and the histogram
// read the ring. So:
//   phase 1  warp 0 loads the block's arrivals (cp.async) and scalars, and
//            lane i runs the scalar chain of agent i for all K ticks:
//            completion, post credit, launch, pre credit, admission and
//            every counter but EFFECTIVE, with no shuffle, barrier or ring
//            access in the loop (the lanes' chains share one instruction
//            stream). It writes each tick's schedule to shared memory:
//            head_t and tail_t before tick t (t = 0..K), so tick t completes
//            the requests [head_t, head_t+1) and admits [tail_t, tail_t+1)
//            at microtick m_t = tick_0 + t;
//   meanwhile warp 1 + i loads agent i's ring (16-byte cp.async where R and
//            the addresses allow) and histogram into shared memory and
//            writes the ring out unchanged, hidden behind the chain;
//   phase 2  after one barrier, warp 1 + i takes agent i's requests
//            completed in the interval, [head_0, head_K), one a lane in
//            turn: request s completes at the last t with head_t <= s, and
//            arrived at ring[s & (R-1)] if s < tail_0, else at m_t' for the
//            last t' with tail_t' <= s (both by bisection of the schedule).
//            lat = m_t + 1 - arrival goes to an int32 sum per tick and,
//            clipped, to the histogram (shared atomicAdd; integer sums do
//            not depend on order, so the bits match), lat <= slo to a
//            count. In the same loop the last R requests admitted, each
//            the last writer of its slot, store their admission microtick
//            over the output ring's copy; every other slot keeps its input
//            value. Every lane folds lat_sum = lat_sum + (float)lsum[t] for
//            t = 0..K-1 in order, every tick included (-0 + 0 = +0), which
//            is the plain version's float sequence. The histogram goes out.
//
// Recording (the request-attribution tap, repro/sim/step.py::
// sim_interval_recorded): with o_ticks given, the kernel also writes the
// counters after every tick, (A, K, NCOUNTERS) int32. Phase 1 writes each
// tick's row as its chain computes it, three 16-byte stores (the rows are
// 48 bytes; o_ticks is 16-byte aligned), EFFECTIVE with its stale value,
// which phase 2 overwrites after the block's barrier. Phase 2 counts each
// tick's completions within the SLO (lat <= slo at the request's
// completion tick) by shared atomicAdd into the agent's column of the
// arrivals rows, which phase 1 no longer reads, and a prefix over the K
// ticks writes EFFECTIVE; its last value is the counter's output. The
// recording is a second instantiation of the kernel (RECORD), so the
// unrecorded kernel is the same code as before, and the shared memory the
// same.
//
// Precondition (every state the twin reaches from sim_init under
// action_caps and spread_arrivals): monotone counters head <= p_inf <=
// launch <= p_pre <= tail with tail - head <= R (compared as int32
// differences), credits, caps and arrivals >= 0. Then a slot is rewritten
// only after its request completed, and the rule of phase 2 reads what the
// plain version reads.
//
// Bound: by bytes, 2,468 B read + 2,364 B written per agent at R=512, H=64,
// K=20, so 0.0115 us at A=8 and 2.95 us at A=2048 over 3.35 TB/s. Latency
// sets the time instead, in series: the scalars' load, the chain of K
// dependent ticks (float credit, truncation, integer minima; ~120 cycles a
// tick) and the requests' bisections of the schedule. The ring's load and
// copy hide behind the chain, and 8 agents' chains share warp 0's
// instructions.
//
// Numerics: built with -fmad=false and no fast math. Credits are
// min(credit + c, c + 1) - (float)n in float32, with jnp.minimum's NaN
// propagation; float->int casts truncate; every other quantity is int32
// with two's-complement wrap, so the result is bit-identical to the plain
// version and the JAX oracle.
#include <cuda_runtime.h>
#include <stdint.h>

// Phase marks: empty here. A build that defines K3_PHASE_MARKS and these
// three as clock64() stamps reads the cycles lane 0 of each warp spends in
// each phase.
#ifndef K3_PHASE_MARKS
#define K3_MARK_START()
#define K3_MARK(phase)
#define K3_MARK_END()
#endif

namespace {

constexpr int LANES = 32;
constexpr int AGENTS_PER_BLOCK = 8;  // agent warps a block, besides warp 0
constexpr size_t MAX_SMEM = 232448;   // dynamic shared memory a block may take
constexpr unsigned FULL = 0xffffffffu;
enum {
  TAIL, PPRE, LAUNCH, PINF, HEAD, BUSY, DONE_AT, ARRIVED, DROPPED, COMPLETED,
  EFFECTIVE, TICK, NCOUNTERS
};
enum { CAP_PRE, CAP_POST, CAP_BATCH, CAP_TBATCH, CAP_QCAP, CAP_SLO, NCAPS };
static_assert(NCOUNTERS == 12, "a recorded tick row is three int4 stores");

// jnp.minimum / torch.minimum: NaN propagates (fminf would drop it)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Words of shared memory before the agents' rings: the arrivals and the
// two schedules in rows of pitch AGENTS_PER_BLOCK + 1, and the chains'
// scalars, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int shared_words(int K) {
  return ((AGENTS_PER_BLOCK + 1) * (3 * K + 2) +
          AGENTS_PER_BLOCK * (NCOUNTERS + 2 + NCAPS) + 3) & ~3;
}

template <bool RECORD>
__global__ void __launch_bounds__(LANES * (AGENTS_PER_BLOCK + 1)) queue_advance_kernel(
    const int* __restrict__ arrive, const int* __restrict__ counters,
    const float* __restrict__ credits, const float* __restrict__ lat_sum,
    const int* __restrict__ hist, const int* __restrict__ arrivals,
    const float* __restrict__ caps, int* __restrict__ o_arrive,
    int* __restrict__ o_counters, float* __restrict__ o_credits,
    float* __restrict__ o_lat_sum, int* __restrict__ o_hist,
    int* __restrict__ o_ticks, int A, int R, int H, int K) {
  // Warp 0 runs the scalar chains (lane i for the block's agent i); warp
  // 1 + i takes agent i's ring. Shared memory: first, agent-minor in rows
  // of an odd pitch P, the arrivals [K] and the schedule [K + 1] of head
  // and of tail before each tick; the scalars the chains start from; then
  // per agent the input ring (R), the histogram (H) and the per-tick
  // latency sums (K), padded to 16 bytes.
  extern __shared__ __align__(16) int smem[];
  constexpr int NB = AGENTS_PER_BLOCK;
  constexpr int P = NB + 1;  // odd row pitch: rows and columns both spread over banks
  const int nb_max = blockDim.x / LANES - 1;  // agents a full block holds
  const int w = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int first = blockIdx.x * nb_max;
  const int nb = min(nb_max, A - first);      // agents in this block
  int* arr = smem;
  int* s_head = arr + K * P;
  int* s_tail = s_head + (K + 1) * P;
  int* s_cnt = s_tail + (K + 1) * P;           // [NB][NCOUNTERS]
  float* s_cr = reinterpret_cast<float*>(s_cnt + NB * NCOUNTERS);  // [NB][2]
  float* s_caps = s_cr + NB * 2;               // [NB][NCAPS]
  const int stride = (R + H + K + 3) & ~3;
  const int i = w - 1;                         // this warp's agent in the block
  const bool mine = w >= 1 && i < nb;
  const size_t agent = first + (mine ? i : 0);
  int* ring = smem + shared_words(K) + (mine ? i : 0) * stride;
  int* hs = ring + R;
  int* lsum = hs + H;
  const unsigned rmask = static_cast<unsigned>(R - 1);
  int* o_ring = o_arrive + agent * R;
  K3_MARK_START();

  if (w == 0) {
    // ---- phase 1: the scalar chains, lane i for agent first + i; the
    // arrivals and the scalars land by cp.async in one group ----
    for (int e = lane; e < nb * K; e += LANES)
      cp_async4(arr + (e % K) * P + e / K, arrivals + first * static_cast<size_t>(K) + e);
    for (int e = lane; e < nb * NCOUNTERS; e += LANES)
      cp_async4(s_cnt + e, counters + first * static_cast<size_t>(NCOUNTERS) + e);
    for (int e = lane; e < nb * 2; e += LANES)
      cp_async4(reinterpret_cast<int*>(s_cr) + e,
                reinterpret_cast<const int*>(credits) + first * size_t{2} + e);
    for (int e = lane; e < nb * NCAPS; e += LANES)
      cp_async4(reinterpret_cast<int*>(s_caps) + e,
                reinterpret_cast<const int*>(caps) + first * static_cast<size_t>(NCAPS) + e);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    K3_MARK(LOAD);
    const bool chain = lane < nb;
    const size_t a = first + (chain ? lane : 0);
    const int me = chain ? lane : 0;
    int c[NCOUNTERS];
#pragma unroll
    for (int j = 0; j < NCOUNTERS; ++j) c[j] = s_cnt[me * NCOUNTERS + j];
    float cr_pre = s_cr[me * 2], cr_post = s_cr[me * 2 + 1];
    const float* cp = s_caps + me * NCAPS;
    const float c_pre = cp[CAP_PRE], c_post = cp[CAP_POST];
    const int batch_slots = static_cast<int>(cp[CAP_BATCH]);
    const int t_batch = static_cast<int>(cp[CAP_TBATCH]);
    const int qcap = static_cast<int>(cp[CAP_QCAP]);
    if (chain) {
      for (int t = 0; t < K; ++t) {
        const int n_arr = arr[t * P + lane];
        const int m = c[TICK];
        s_head[t * P + lane] = c[HEAD];
        s_tail[t * P + lane] = c[TAIL];

        // (1) inference completion
        const bool done = c[BUSY] > 0 && m >= c[DONE_AT];
        const int p_inf = done ? c[LAUNCH] : c[PINF];
        int busy = done ? 0 : c[BUSY];

        // (2) post service: the n_post oldest post-queue requests complete
        float post_credit = nan_min(cr_post + c_post, c_post + 1.0f);
        const int n_post = min(static_cast<int>(post_credit), p_inf - c[HEAD]);
        post_credit = post_credit - static_cast<float>(n_post);
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
        c[TICK] = m + 1;
        cr_pre = pre_credit;
        cr_post = post_credit;
        if (RECORD) {  // three 16-byte stores; EFFECTIVE is phase 2's
          int4* row = reinterpret_cast<int4*>(o_ticks + (a * K + t) * NCOUNTERS);
          row[0] = make_int4(c[0], c[1], c[2], c[3]);
          row[1] = make_int4(c[4], c[5], c[6], c[7]);
          row[2] = make_int4(c[8], c[9], c[10], c[11]);
        }
      }
      s_head[K * P + lane] = c[HEAD];
      s_tail[K * P + lane] = c[TAIL];
#pragma unroll
      for (int j = 0; j < NCOUNTERS; ++j)  // EFFECTIVE comes from phase 2
        if (j != EFFECTIVE) o_counters[a * NCOUNTERS + j] = c[j];
      o_credits[a * 2] = cr_pre;
      o_credits[a * 2 + 1] = cr_post;
    }
    K3_MARK(SCALAR);
  }

  // ---- the agent warps, meanwhile: the ring lands and goes out as it came
  // in (phase 2 then rewrites only the slots admissions wrote) ----
  int head0 = 0, tail0 = 0, tick0 = 0, eff0 = 0, slo = 0;
  float ls0 = 0.0f;
  if (mine) {
    head0 = counters[agent * NCOUNTERS + HEAD];
    tail0 = counters[agent * NCOUNTERS + TAIL];
    tick0 = counters[agent * NCOUNTERS + TICK];
    eff0 = counters[agent * NCOUNTERS + EFFECTIVE];
    slo = static_cast<int>(caps[agent * NCAPS + CAP_SLO]);
    ls0 = lat_sum[agent];
    const int* g_ring = arrive + agent * R;
    const bool vec = (R & 3) == 0 &&
        ((reinterpret_cast<uintptr_t>(g_ring) |
          reinterpret_cast<uintptr_t>(o_ring)) & 15) == 0;
    if (vec) {
      for (int p = 4 * lane; p < R; p += 4 * LANES) cp_async16(ring + p, g_ring + p);
    } else {
      for (int p = lane; p < R; p += LANES) cp_async4(ring + p, g_ring + p);
    }
    for (int h = lane; h < H; h += LANES) cp_async4(hs + h, hist + agent * H + h);
    cp_async_commit();
    for (int t = lane; t < K; t += LANES) lsum[t] = 0;
    cp_async_wait<0>();
    __syncwarp();
    K3_MARK(LOAD);
    if (vec) {
      for (int p = 4 * lane; p < R; p += 4 * LANES)
        *reinterpret_cast<int4*>(o_ring + p) = *reinterpret_cast<const int4*>(ring + p);
    } else {
      for (int p = lane; p < R; p += LANES) o_ring[p] = ring[p];
    }
    K3_MARK(COPY);
  }
  __syncthreads();  // the schedules are written; the output rings hold the input
  K3_MARK(BARRIER);
  if (!mine) {
    K3_MARK_END();
    return;
  }

  // ---- phase 2: the agent's requests, over all ticks at once ----
  const int* sh = s_head + i;  // this agent's schedule, P apart
  const int* st = s_tail + i;
  const int n_done = sh[K * P] - head0;  // completed in the interval
  const int n_in = tail0 - head0;         // in flight at its start
  const int n_adm = st[K * P] - tail0;   // admitted in the interval
  // lane by lane: request j completed in the interval, and the admitted
  // request w0 + j, the last to write its slot if no later one maps onto it
  // (the last R admitted). The ticks come from bisections of the schedule
  // (the last tick whose segment starts at or before the request), all
  // three in the same steps so that their reads overlap.
  const int w0 = max(n_adm - R, 0);
  // recording: this agent's column of the arrivals rows (free now) counts
  // each tick's completions within the SLO
  int* ecnt = arr + i;
  if (RECORD) {
    for (int t = lane; t < K; t += LANES) ecnt[t * P] = 0;
    __syncwarp();
  }
  int neff = 0;
  for (int j = lane; j < max(n_done, n_adm - w0); j += LANES) {
    const int jc = j, ja = j - n_in, jw = w0 + j;
    int tc = 0, ta = 0, tw = 0;
    auto step = [&](int s) {
      tc += tc + s < K && sh[(tc + s) * P] - head0 <= jc ? s : 0;
      ta += ta + s < K && st[(ta + s) * P] - tail0 <= ja ? s : 0;
      tw += tw + s < K && st[(tw + s) * P] - tail0 <= jw ? s : 0;
    };
    if (K <= 32) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) step(s);
    } else {
      for (int s = 1 << (31 - __clz(K - 1)); s > 0; s >>= 1) step(s);
    }
    if (j < n_done) {
      const int arrival = ja < 0 ? ring[(static_cast<unsigned>(head0) + j) & rmask]
                                 : tick0 + ta;
      const int lat = tick0 + tc + 1 - arrival;
      atomicAdd(&lsum[tc], lat);
      neff += lat <= slo;
      if (RECORD && lat <= slo) atomicAdd(&ecnt[tc * P], 1);
      atomicAdd(&hs[lat < 0 ? 0 : (lat > H - 1 ? H - 1 : lat)], 1);
    }
    if (jw < n_adm)
      o_ring[(static_cast<unsigned>(tail0) + jw) & rmask] = tick0 + tw;
  }
  neff = __reduce_add_sync(FULL, neff);
  __syncwarp();  // the tick sums and the histogram are complete
  K3_MARK(REQUESTS);

  // lat_sum folds the tick sums in tick order, in every lane alike
  float ls = ls0;
  if (K <= 32) {
#pragma unroll
    for (int t = 0; t < 32; ++t)
      if (t < K) ls = ls + static_cast<float>(lsum[t]);
  } else {
    for (int t = 0; t < K; ++t) ls = ls + static_cast<float>(lsum[t]);
  }
  if (lane == 0) {
    o_lat_sum[agent] = ls;
    o_counters[agent * NCOUNTERS + EFFECTIVE] = eff0 + neff;
  }
  if (RECORD) {  // EFFECTIVE after each tick: a prefix of the tick counts
    for (int t = lane; t < K; t += LANES) {
      int e = eff0;
      for (int u = 0; u <= t; ++u) e += ecnt[u * P];
      o_ticks[(agent * K + t) * NCOUNTERS + EFFECTIVE] = e;
    }
  }
  K3_MARK(FOLD);
  for (int h = lane; h < H; h += LANES) o_hist[agent * H + h] = hs[h];
  K3_MARK(STORE);
  K3_MARK_END();
}

// Shared memory a block of nb agents takes (the layout in the kernel).
size_t smem_bytes(int nb, int R, int H, int K) {
  const size_t per_agent = (static_cast<size_t>(R) + H + K + 3) & ~static_cast<size_t>(3);
  return (shared_words(K) + nb * per_agent) * sizeof(int);
}

}  // namespace

extern "C" int queue_advance_launch(
    const int* arrive, const int* counters, const float* credits,
    const float* lat_sum, const int* hist, const int* arrivals,
    const float* caps, int* o_arrive, int* o_counters, float* o_credits,
    float* o_lat_sum, int* o_hist, int* o_ticks, int A, int R, int H, int K,
    void* stream) {
  if (A <= 0 || R <= 0 || (R & (R - 1)) != 0 || H < 1 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // as many agents a block as the shared memory holds, up to 8
  int nb = A < AGENTS_PER_BLOCK ? A : AGENTS_PER_BLOCK;
  while (nb > 1 && smem_bytes(nb, R, H, K) > MAX_SMEM) --nb;
  const size_t smem = smem_bytes(nb, R, H, K);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  // o_ticks (A, K, NCOUNTERS) picks the recording instantiation
  auto kernel = o_ticks == nullptr ? queue_advance_kernel<false>
                                   : queue_advance_kernel<true>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(A + nb - 1) / nb, LANES * (nb + 1), smem,
           static_cast<cudaStream_t>(stream)>>>(
      arrive, counters, credits, lat_sum, hist, arrivals, caps, o_arrive,
      o_counters, o_credits, o_lat_sum, o_hist, o_ticks, A, R, H, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* queue_advance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
