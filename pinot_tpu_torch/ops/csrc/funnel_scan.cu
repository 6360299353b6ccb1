// The ordered funnel's per-key sorted row scan, for NVIDIA Hopper (sm_90a).
//
// Replaces the lax.scan of pinot_tpu/query/aggs_stats.py:_ordered_funnel_reach
// (lines 489-536): the deepest ORDERED funnel step each correlate key reached.
// The wrapper (ops/funnel_scan.py) sorts the rows by (key, ts) with torch,
// packs the S step flags into one byte a row and finds the runs of equal keys
// (each run's key, start and length; the masked rows' sentinel run is not
// among them); this kernel walks the runs.
//
// One thread owns one key's run.  It carries the S chain-start timestamps in
// registers: carry[s] is the latest start of any chain that has reached step
// s+1.  A row extends step s from the PRE-update carry[s-1] when its flag s is
// set, that carry is live and the row lies within `window` of it; a row with
// flag 0 starts a chain (carry[0] = ts).  The key's reach (the live carries,
// maxed over its rows) goes straight into out[key]: a key has one owner, so
// no atomics, and keys with no rows keep the wrapper's zeros.
//
// What bounds it: the 9 bytes a row (f64 ts, uint8 flags) and the 20 a run
// (int32 key, int64 start and length) read once, plus the table, against the
// 3.35 TB/s of HBM.  A thread's walk is a
// chain of dependent loads, and neighbouring threads read a run apart, so the
// loads do not coalesce; the rows of one run share cache lines, which is what
// this simple design leans on.  A warp-cooperative walk is a later step.

#include <cuda_runtime.h>
#include <stdint.h>

#define FUNNEL_MAX_STEPS 8
#define FUNNEL_BLOCK 256

namespace {

__global__ void __launch_bounds__(FUNNEL_BLOCK)
funnel_scan_kernel(const int32_t* __restrict__ run_keys, const double* __restrict__ ts,
                   const uint8_t* __restrict__ flags, const int64_t* __restrict__ starts,
                   const int64_t* __restrict__ counts, int64_t runs, int num_steps,
                   double window, int32_t* __restrict__ out) {
  const int64_t r = (int64_t)blockIdx.x * FUNNEL_BLOCK + threadIdx.x;
  if (r >= runs) return;
  const int64_t begin = starts[r];
  const int64_t n = counts[r];
  const double NEG = -4611686018427387904.0;  // -(2^62), the "no chain" carry
  double carry[FUNNEL_MAX_STEPS];
#pragma unroll
  for (int s = 0; s < FUNNEL_MAX_STEPS; ++s) carry[s] = NEG;
  int32_t best = 0;
  for (int64_t i = begin; i < begin + n; ++i) {
    const double t = ts[i];
    const uint32_t f = flags[i];
    // high steps first, so step s reads carry[s-1] before its update
#pragma unroll
    for (int s = FUNNEL_MAX_STEPS - 1; s >= 1; --s) {
      if (s < num_steps && ((f >> s) & 1u) && carry[s - 1] > NEG && t - carry[s - 1] <= window) {
        carry[s] = carry[s] >= carry[s - 1] ? carry[s] : carry[s - 1];
      }
    }
    if (f & 1u) carry[0] = t;
    int32_t reach = 0;
#pragma unroll
    for (int s = 0; s < FUNNEL_MAX_STEPS; ++s) reach += (s < num_steps && carry[s] > NEG) ? 1 : 0;
    best = reach > best ? reach : best;
  }
  out[run_keys[r]] = best;
}

}  // namespace

extern "C" {

// run_keys: the runs' keys, each in [0, cells).  out: zeroed int32[cells] on
// the current device.  Returns a cudaError_t.
int pinot_funnel_scan(const void* run_keys, const void* ts, const void* flags, const void* starts,
                      const void* counts, long long runs, int num_steps, long long cells, double window,
                      void* out, void* stream) {
  if (runs < 0 || cells < 0 || num_steps < 1 || num_steps > FUNNEL_MAX_STEPS) return (int)cudaErrorInvalidValue;
  if (runs == 0) return (int)cudaSuccess;
  const long long blocks = (runs + FUNNEL_BLOCK - 1) / FUNNEL_BLOCK;
  funnel_scan_kernel<<<(unsigned)blocks, FUNNEL_BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)run_keys, (const double*)ts, (const uint8_t*)flags, (const int64_t*)starts,
      (const int64_t*)counts, (int64_t)runs, num_steps, window, (int32_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
