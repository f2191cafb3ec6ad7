// span_stamp: the flight recorder's device clock, hand-written for Hopper
// (sm_90a).
//
// Replaces no TPU kernel. The JAX package times the phases of its compiled
// fleet run with host callbacks (repro/obs/trace.py, io_callback pairs);
// the port's compiled run is a set of CUDA graphs, in which a host-side
// range (NVTX, torch.profiler.record_function) runs once, at capture, and
// never at a replay, and a timing event captured in a graph is one event
// that every replay overwrites. So a span's two ends are nodes of the
// graph: each is this kernel, which stamps the device's clock into device
// memory, and the host reads the stamps back once, at the end of the run.
//
// One thread. It reads the absolute episode index e = *episode + delta and
// the sampling period k = *every from DEVICE memory (the graph driver's
// episode counter and the tracer's period: nothing host-side is baked into
// a captured graph but the slot and two constants of the run), and, only
// where e >= base and e % k == 0, writes %globaltimer (ns) to
//   stamps[(e / k - ceil(base / k)) * n_slots + slot]
// if that row is below n_rows. Rows of episodes that are not sampled are
// never written, so one capture serves any sampling.
//
// Bound: by bytes, two 8-byte reads and one 8-byte write (24 B, 7e-6 us
// at 3.35 TB/s); what a stamp costs is a graph node, a launch of about
// two microseconds. %globaltimer's resolution is the card's (measured by
// chip_smoke.py, [stamp]); spans shorter than it are not resolved.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void span_stamp_kernel(unsigned long long* __restrict__ stamps,
                                  const long long* __restrict__ episode,
                                  const long long* __restrict__ every,
                                  long long delta, long long base, int n_rows,
                                  int n_slots, int slot) {
  const long long e = *episode + delta;
  const long long k = *every;
  if (k < 1 || e < base || e % k != 0) return;
  const long long row = e / k - (base + k - 1) / k;
  if (row >= n_rows) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  stamps[row * n_slots + slot] = now;
}

}  // namespace

extern "C" int span_stamp_launch(unsigned long long* stamps,
                                 const long long* episode,
                                 const long long* every, long long delta,
                                 long long base, int n_rows, int n_slots,
                                 int slot, void* stream) {
  if (n_rows < 1 || n_slots < 1 || slot < 0 || slot >= n_slots || base < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  span_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      stamps, episode, every, delta, base, n_rows, n_slots, slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* span_stamp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
