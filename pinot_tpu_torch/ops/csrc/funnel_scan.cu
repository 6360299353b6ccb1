// The ordered funnel's per-key row scan, for NVIDIA Hopper (sm_90a).
//
// Replaces the lax.scan of pinot_tpu/query/aggs_stats.py:_ordered_funnel_reach
// (lines 489-536): the deepest ORDERED funnel step each correlate key reached.
// The wrapper (ops/funnel_scan.py) sorts the rows by key alone (one stable
// torch sort), packs the S step flags into one byte a row and finds the runs
// of equal keys (each run's key, start and length).  The rows of a run arrive
// in row order, not in time order; this kernel orders each run by (ts, row)
// and walks it.  Runs longer than `ordered_above` rows (at most
// FUNNEL_RUN_CAP) arrive already ordered by the wrapper and are only walked.
//
// The walk: one thread carries a key's S chain-start timestamps in registers.
// carry[s] is the latest start of any chain that has reached step s+1.  A row
// extends step s from the PRE-update carry[s-1] when its flag s is set, that
// carry is live and the row lies within `window` of it; a row with flag 0
// starts a chain (carry[0] = ts).  The key's reach (the live carries, maxed
// over its rows) goes straight into out[key]: a key has one owner, so no
// atomics, and keys with no rows keep the wrapper's zeros.
//
// What bounds it: the 9 bytes a row (f64 ts, uint8 flags) and the 20 a run
// (int32 key, int64 start and length) read once, plus the table written once,
// against the 3.35 TB/s of HBM; but ordering the runs is compute, not bytes.
// The design: block b owns the runs that start in rows [b*W, (b+1)*W) (W =
// FUNNEL_WINDOW_ROWS); every such run of at most FUNNEL_RUN_CAP rows ends
// within W + FUNNEL_RUN_CAP rows of the window's start, so the block stages
// that one contiguous span into shared memory with coalesced loads.  There it
// sorts the composite key (local run, ts, row) by counting: a row's place is
// its run's start plus the run's rows before it in (ts, row) order; rows of
// different runs never meet; the lanes of a warp read the same row of a
// run at once (a broadcast).  Whole timestamps within 2^41 of the block's
// least (the usual case) fold the row into one exact f64 key, so a pair
// costs one compare.  A row costs its run's length in compares, which is
// why runs above the cap go to the wrapper's sort.  Then one thread walks each run from shared
// memory, the carries in registers, specialised on S; a run the wrapper
// ordered is staged a tile at a time and walked by one thread: a single
// key's walk is sequential, as the DP is, so one huge key is latency bound.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define FUNNEL_MAX_STEPS 8
#define FUNNEL_BLOCK 256
// a block owns the runs that start in a window of this many rows
#define FUNNEL_WINDOW_ROWS 2048
// the longest run a block orders itself (ops/funnel_scan.py RUN_CAP)
#define FUNNEL_RUN_CAP 1024
// rows staged at once: a window's runs of at most FUNNEL_RUN_CAP rows end in it
#define FUNNEL_TILE_ROWS (FUNNEL_WINDOW_ROWS + FUNNEL_RUN_CAP)
#define FUNNEL_ROWS_PER_THREAD (FUNNEL_TILE_ROWS / FUNNEL_BLOCK)
#define FUNNEL_NO_RUN 0xFFFFu

static_assert(FUNNEL_TILE_ROWS % FUNNEL_BLOCK == 0, "the tile is whole rows a thread");
static_assert(FUNNEL_TILE_ROWS < FUNNEL_NO_RUN, "tile positions fit uint16");

namespace {

// -(2^62), the "no chain" carry
constexpr double NEG = -4611686018427387904.0;

// u64 whose unsigned order is torch.sort's order of doubles: -0.0 equal to
// 0.0, every NaN equal and above +inf
__device__ __forceinline__ uint64_t order_key(double t) {
  uint64_t b = (uint64_t)__double_as_longlong(t);
  if ((b << 1) == 0) b = 0;                                             // -0.0
  if ((b & 0x7FFFFFFFFFFFFFFFull) > 0x7FF0000000000000ull) b = 0x7FF8000000000000ull;  // NaN
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

// rows of a block whose timestamps are all whole and within 2^41 of the
// least (epoch milliseconds over 69 years, dates, counters) rank by one key
// a row, (ts - least) * 2^12 + tile position, exact in f64 (41 + 12 bits)
// and distinct, so ties need no second compare; the walk decodes ts from it
#define FUNNEL_KEY_SPAN 2199023255552.0  // 2^41
#define FUNNEL_KEY_SCALE 4096.0           // 2^12 > FUNNEL_TILE_ROWS
static_assert(FUNNEL_TILE_ROWS <= 4096, "tile positions fit the key's 12 low bits");

__device__ __forceinline__ double decode_ts(double key, double least) {
  return least + trunc(key * (1.0 / FUNNEL_KEY_SCALE));
}

// A key's walk: the S chain-start carries in registers, one row at a time
// in (ts, row) order (high steps first, so step s reads carry[s-1] before
// its update).  A dead carry[s-1] (NEG) moves nothing: the max keeps
// carry[s].  Only carry[0] can fall (to a ts at or below NEG, or NaN), so
// without such timestamps the live carries only grow and the key's reach is
// their final count; with them the walk keeps the running maximum.
template <int S>
struct Walk {
  double c[S];

  __device__ __forceinline__ Walk() {
#pragma unroll
    for (int s = 0; s < S; ++s) c[s] = NEG;
  }

  __device__ __forceinline__ void row(double t, uint32_t f, double window) {
#pragma unroll
    for (int s = S - 1; s >= 1; --s) {
      if (((f >> s) & 1u) && t - c[s - 1] <= window && c[s] < c[s - 1]) c[s] = c[s - 1];
    }
    if (f & 1u) c[0] = t;
  }

  __device__ __forceinline__ int32_t live() const {
    int32_t r = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) r += c[s] > NEG ? 1 : 0;
    return r;
  }
};

// n rows from shared memory (keys when keyed: ts decoded against least);
// with track, best keeps the running maximum of the live carries
template <int S>
__device__ __forceinline__ void walk_rows(Walk<S>& w, int32_t& best, bool track, const double* t,
                                          const uint8_t* f, int n, double window, bool keyed, double least) {
  if (track) {
    for (int i = 0; i < n; ++i) {
      w.row(keyed ? decode_ts(t[i], least) : t[i], f[i], window);
      const int32_t r = w.live();
      best = r > best ? r : best;
    }
  } else if (keyed) {
#pragma unroll 4
    for (int i = 0; i < n; ++i) w.row(decode_ts(t[i], least), f[i], window);
  } else {
#pragma unroll 4
    for (int i = 0; i < n; ++i) w.row(t[i], f[i], window);
  }
}

// a timestamp that can make carry[0] fall, or NaN (which also orders apart)
__device__ __forceinline__ bool odd_ts(double t) { return !(t > NEG); }

// tile_first[b] = the first run whose start is at least b * FUNNEL_WINDOW_ROWS, b in [0, tiles]
__global__ void funnel_scan_tiles_kernel(const int64_t* __restrict__ starts, int64_t runs, int64_t tiles,
                                         int64_t* __restrict__ tile_first) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b > tiles) return;
  const int64_t target = b * FUNNEL_WINDOW_ROWS;
  int64_t lo = 0, hi = runs;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (starts[mid] < target) lo = mid + 1; else hi = mid;
  }
  tile_first[b] = lo;
}

template <int S>
__global__ void __launch_bounds__(FUNNEL_BLOCK)
funnel_scan_kernel(const int32_t* __restrict__ run_keys, const double* __restrict__ ts,
                   const uint8_t* __restrict__ flags, const int64_t* __restrict__ starts,
                   const int64_t* __restrict__ counts, const int64_t* __restrict__ tile_first,
                   int64_t ordered_above, double window, int32_t* __restrict__ out) {
  __shared__ double t_s[FUNNEL_TILE_ROWS];  // ts, or a row's key when keyed
  __shared__ uint8_t f_s[FUNNEL_TILE_ROWS];
  // a row's local run (FUNNEL_NO_RUN: not in a run this block orders), then its place
  __shared__ uint16_t slot[FUNNEL_TILE_ROWS];
  __shared__ uint16_t run_lo[FUNNEL_WINDOW_ROWS];
  __shared__ uint16_t run_len[FUNNEL_WINDOW_ROWS];  // 0: a run the wrapper ordered (or an empty one)
  __shared__ uint16_t long_runs[FUNNEL_WINDOW_ROWS];
  __shared__ double warp_lo[FUNNEL_BLOCK / 32], warp_hi[FUNNEL_BLOCK / 32];
  __shared__ int n_long;

  const int tid = threadIdx.x;
  const int64_t r0 = tile_first[blockIdx.x], r1 = tile_first[blockIdx.x + 1];
  if (r0 == r1) return;
  const int nruns = (int)(r1 - r0);
  const int64_t base = starts[r0];
  const int64_t span = starts[r1 - 1] + counts[r1 - 1] - base;
  const int n = (int)(span < FUNNEL_TILE_ROWS ? span : FUNNEL_TILE_ROWS);
  if (tid == 0) n_long = 0;

  // 1. stage the span: coalesced loads, 8 + 1 bytes a row; the least and
  // greatest ts and whether all are whole
  int odd_rows = 0, whole = 1;
  double lo_t = CUDART_INF, hi_t = -CUDART_INF;
  for (int i = tid; i < n; i += FUNNEL_BLOCK) {
    const double t = ts[base + i];
    odd_rows |= odd_ts(t);
    whole &= t == rint(t);
    lo_t = fmin(lo_t, t);
    hi_t = fmax(hi_t, t);
    t_s[i] = t;
    f_s[i] = flags[base + i];
    slot[i] = FUNNEL_NO_RUN;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo_t = fmin(lo_t, __shfl_xor_sync(0xFFFFFFFFu, lo_t, o));
    hi_t = fmax(hi_t, __shfl_xor_sync(0xFFFFFFFFu, hi_t, o));
  }
  if ((tid & 31) == 0) {
    warp_lo[tid >> 5] = lo_t;
    warp_hi[tid >> 5] = hi_t;
  }
  const bool odd = __syncthreads_or(odd_rows) != 0;
  for (int k = 0; k < FUNNEL_BLOCK / 32; ++k) {
    lo_t = fmin(lo_t, warp_lo[k]);
    hi_t = fmax(hi_t, warp_hi[k]);
  }
  const bool keyed = __syncthreads_and(whole) && hi_t - lo_t < FUNNEL_KEY_SPAN;

  // 2. the block's runs: a short run's rows take its local index; keyed
  // rows take their keys
  for (int j = tid; j < nruns; j += FUNNEL_BLOCK) {
    const int64_t c = counts[r0 + j];
    if (c <= ordered_above) {
      const int lo = (int)(starts[r0 + j] - base);
      run_lo[j] = (uint16_t)lo;
      run_len[j] = (uint16_t)c;
      for (int i = lo; i < lo + (int)c; ++i) slot[i] = (uint16_t)j;
    } else {
      run_len[j] = 0;
      long_runs[atomicAdd(&n_long, 1)] = (uint16_t)j;
    }
  }
  if (keyed) {
    for (int i = tid; i < n; i += FUNNEL_BLOCK) t_s[i] = (t_s[i] - lo_t) * FUNNEL_KEY_SCALE + (double)i;
  }
  __syncthreads();

  // 3. each row's place in its run: the rows before it in (ts, row) order
  for (int p = tid; p < n; p += FUNNEL_BLOCK) {
    const uint32_t j = slot[p];
    if (j == FUNNEL_NO_RUN) continue;
    const int lo = run_lo[j], hi = lo + run_len[j];
    int below = 0;
    if (keyed) {
      const double kp = t_s[p];
#pragma unroll 8
      for (int q = lo; q < hi; ++q) below += t_s[q] < kp ? 1 : 0;
    } else if (!odd) {
      const double tp = t_s[p];
#pragma unroll 4
      for (int q = lo; q < hi; ++q) {
        const double tq = t_s[q];
        below += (tq < tp || (tq == tp && q < p)) ? 1 : 0;
      }
    } else {
      const uint64_t kp = order_key(t_s[p]);
      for (int q = lo; q < hi; ++q) {
        const uint64_t kq = order_key(t_s[q]);
        below += (kq < kp || (kq == kp && q < p)) ? 1 : 0;
      }
    }
    slot[p] = (uint16_t)(lo + below);
  }
  __syncthreads();

  // 4. every ranked row to its place
  double tt[FUNNEL_ROWS_PER_THREAD];
  uint8_t ff[FUNNEL_ROWS_PER_THREAD];
  uint16_t dd[FUNNEL_ROWS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < FUNNEL_ROWS_PER_THREAD; ++k) {
    const int p = tid + k * FUNNEL_BLOCK;
    dd[k] = p < n ? slot[p] : (uint16_t)FUNNEL_NO_RUN;
    tt[k] = p < n ? t_s[p] : 0.0;
    ff[k] = p < n ? f_s[p] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < FUNNEL_ROWS_PER_THREAD; ++k) {
    if (dd[k] != FUNNEL_NO_RUN) {
      t_s[dd[k]] = tt[k];
      f_s[dd[k]] = ff[k];
    }
  }
  __syncthreads();

  // 5. one thread walks each short run from shared memory
  for (int j = tid; j < nruns; j += FUNNEL_BLOCK) {
    const int len = run_len[j];
    if (len == 0) continue;
    Walk<S> w;
    int32_t best = 0;
    walk_rows(w, best, odd, t_s + run_lo[j], f_s + run_lo[j], len, window, keyed, lo_t);
    out[run_keys[r0 + j]] = odd ? best : w.live();
  }

  // 6. the runs the wrapper ordered: staged a tile at a time, walked by thread 0
  const int nl = n_long;
  for (int l = 0; l < nl; ++l) {
    const int64_t r = r0 + long_runs[l];
    const int64_t s0 = starts[r], c = counts[r];
    Walk<S> w;
    int32_t best = 0;
    bool track = false;
    for (int64_t off = 0; off < c; off += FUNNEL_TILE_ROWS) {
      const int m = (int)(c - off < FUNNEL_TILE_ROWS ? c - off : FUNNEL_TILE_ROWS);
      __syncthreads();  // the walks before are done with t_s and f_s
      odd_rows = 0;
      for (int i = tid; i < m; i += FUNNEL_BLOCK) {
        const double t = ts[s0 + off + i];
        odd_rows |= odd_ts(t);
        t_s[i] = t;
        f_s[i] = flags[s0 + off + i];
      }
      const bool tile_odd = __syncthreads_or(odd_rows) != 0;
      if (tid == 0) {
        if (tile_odd && !track) {  // the count so far is the maximum so far
          best = w.live();
          track = true;
        }
        walk_rows(w, best, track, t_s, f_s, m, window, false, 0.0);
      }
    }
    if (tid == 0) out[run_keys[r]] = track ? best : w.live();
  }
}

template <int S>
cudaError_t launch(const void* run_keys, const void* ts, const void* flags, const void* starts, const void* counts,
                   long long tiles, long long ordered_above, double window, const int64_t* tile_first, void* out,
                   cudaStream_t st) {
  funnel_scan_kernel<S><<<(unsigned)tiles, FUNNEL_BLOCK, 0, st>>>(
      (const int32_t*)run_keys, (const double*)ts, (const uint8_t*)flags, (const int64_t*)starts,
      (const int64_t*)counts, tile_first, (int64_t)ordered_above, window, (int32_t*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The rows each block's window covers (ops/funnel_scan.py sizes the
// tile_first scratch with it: rows / this, rounded up, plus one entries).
long long pinot_funnel_window_rows() { return FUNNEL_WINDOW_ROWS; }

// The longest run the kernel orders itself; `ordered_above` may not exceed it.
long long pinot_funnel_run_cap() { return FUNNEL_RUN_CAP; }

// run_keys: the runs' keys, each in [0, cells); starts ascending, the runs
// disjoint spans of the `rows` rows, each of at least one row; runs longer
// than ordered_above rows already ordered by (ts, row).  tile_first: int64
// scratch of ceil(rows / FUNNEL_WINDOW_ROWS) + 1 entries.  out: zeroed int32[cells] on
// the current device.  Returns a cudaError_t.
int pinot_funnel_scan(const void* run_keys, const void* ts, const void* flags, const void* starts,
                      const void* counts, long long runs, long long rows, long long ordered_above, int num_steps,
                      long long cells, double window, void* tile_first, void* out, void* stream) {
  if (runs < 0 || rows < 0 || cells < 0 || num_steps < 1 || num_steps > FUNNEL_MAX_STEPS || ordered_above < 0 ||
      ordered_above > FUNNEL_RUN_CAP)
    return (int)cudaErrorInvalidValue;
  if (runs == 0) return (int)cudaSuccess;
  const long long tiles = (rows + FUNNEL_WINDOW_ROWS - 1) / FUNNEL_WINDOW_ROWS;
  cudaStream_t st = (cudaStream_t)stream;
  funnel_scan_tiles_kernel<<<(unsigned)((tiles + 1 + 255) / 256), 256, 0, st>>>(
      (const int64_t*)starts, (int64_t)runs, (int64_t)tiles, (int64_t*)tile_first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t* tf = (const int64_t*)tile_first;
  switch (num_steps) {
    case 1: err = launch<1>(run_keys, ts, flags, starts, counts, tiles, ordered_above, window, tf, out, st); break;
    case 2: err = launch<2>(run_keys, ts, flags, starts, counts, tiles, ordered_above, window, tf, out, st); break;
    case 3: err = launch<3>(run_keys, ts, flags, starts, counts, tiles, ordered_above, window, tf, out, st); break;
    case 4: err = launch<4>(run_keys, ts, flags, starts, counts, tiles, ordered_above, window, tf, out, st); break;
    case 5: err = launch<5>(run_keys, ts, flags, starts, counts, tiles, ordered_above, window, tf, out, st); break;
    case 6: err = launch<6>(run_keys, ts, flags, starts, counts, tiles, ordered_above, window, tf, out, st); break;
    case 7: err = launch<7>(run_keys, ts, flags, starts, counts, tiles, ordered_above, window, tf, out, st); break;
    default: err = launch<8>(run_keys, ts, flags, starts, counts, tiles, ordered_above, window, tf, out, st); break;
  }
  return (int)err;
}

}  // extern "C"
