// Fused filter -> dense group-by scan for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pinot_tpu/ops/pallas_scan.py:fused_group_tables_pallas
// (its body scan_kernel and the in-register lane unpack _lane_unpack).  Same
// inputs, same tables: one pass over the rows; per entry an exact per-group
// count, int_sum (<= 32-bit ints read through the entry's limb plan) or
// int64_sum (signed-magnitude limbs); every entry's mask is ANDed with the
// optional range-index bitmap words and the optional code range lo <= c < hi.
//
// What bounds it on this card: the bytes of key, masks, values and bitmap
// words, each read once, against 3.35 TB/s of HBM (a few bytes a row); then
// the shared-memory atomics (one or two a counted row and entry), and the
// merge of the block tables into the global table.
//
// What the design does about that:
// - Compile-time specialisation.  The row loop is a template on the key mode
//   and the value mode.  The two instantiations the SQL path launches (raw
//   int32 codes or 16-bit lanes of packed words, decoded with constant
//   shifts and masks, with every sum entry over int32) run no per-row type
//   switch and no 64-bit division.  One generic instantiation takes every
//   other key (any integer type, any lane width) and value type, and one
//   generic instantiation the global path.
// - Row tiles.  Each thread takes 16 rows a step, as 4 quads of 4
//   consecutive rows; in a vector tile the 32 lanes of a warp interleave
//   quad by quad over 512 rows, so every load instruction of the warp reads
//   one contiguous run (128 bytes of mask, 256 of 16-bit key words, 512 of
//   int32 values).  The wrapper finds a head row from which every operand
//   is aligned for those loads (views may start at any element); the head,
//   the ragged tail and operands with no common alignment take the same
//   tile code with scalar loads over 16 consecutive rows.
// - One read per distinct mask.  Entries arrive sorted by their mask index;
//   a mask is read once a tile and its bits serve every entry that shares it.
//   A tile whose rows are all masked out reads no values.
// - Cheap tables.  A block keeps an [E, G] table in shared memory: 32-bit
//   counters for counts (a block counts fewer than 2^31 rows) and a lo/hi
//   pair of 32-bit words for sums, added with 32-bit atomics and an exact
//   carry into the high word.  A 64-bit shared atomicAdd compiles to a CAS
//   spin loop (ATOMS.CAST.SPIN.64) on sm_90a; these compile to ATOMS.ADD and,
//   for counts, ATOMS.POPC.INC.32.
// - Few, large blocks: one persistent block of 1024 threads a streaming
//   multiprocessor, so 132 tables flush, not 528, with one global atomic per
//   non-zero slot of each.
// - No per-launch attribute calls: the dynamic shared-memory opt-in of each
//   instantiation, and the occupancy of each instantiation and
//   shared-memory size, are set and computed once and cached.
// Past the shared-memory opt-in (e.g. G = 8192 with 4 sum entries) the rows
// add straight into the global int64 table.  The wrapper (ops/fused_scan.py)
// picks the instantiation and converts int64 to f64.
//
// The member axis (pinot_fused_scan_batch): the JAX package runs W
// same-shape queries as one vmapped launch, whose pallas_call grid gains a
// member axis.  Here each member has its own complete ScanParams (its own
// operand pointers: a shared operand is the same address in every member,
// a stacked one member w's slice), all W ride one kernel parameter block
// (ScanBatch, within the 32 KB parameter space of CUDA 12.1+ on sm_90a),
// blockIdx.y picks the member and the same tile loop runs over x; member
// w's tables are rows [w * E, (w + 1) * E) of the output.  Every member
// reads the operands it shares with the others again: W times the shared
// bytes of one launch, beside the per-member ones.
//
// Plain C interface for ctypes: every pointer and the stream are void*, and
// pinot_fused_scan returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define PINOT_MAX_ENTRIES 16
#define PINOT_MAX_MEMBERS 8
#define PINOT_BLOCK 1024
#define PINOT_MIN_BLOCKS_PER_SM 1
#define PINOT_TILE 16
#define PINOT_WARP_ROWS (32 * PINOT_TILE)

// element type codes shared with ops/fused_scan.py (_DTYPE_CODES)
enum ElemType { T_U8 = 0, T_I8 = 1, T_I16 = 2, T_U16 = 3, T_I32 = 4, T_U32 = 5, T_I64 = 6 };
enum EntryKind { K_COUNT = 0, K_INT_SUM = 1, K_INT64_SUM = 2 };
// instantiation codes shared with ops/fused_scan.py (KEY_MODES, VALUE_MODES)
enum KeyMode { KM_ANY = 0, KM_I32 = 1, KM_P16 = 2 };
enum ValMode { VM_ANY = 0, VM_I32 = 1 };

struct ScanEntry {
  const void* values;  // [n] of vtype; null for count
  int32_t kind;        // EntryKind
  int32_t vtype;       // ElemType of values
  int32_t n_limbs;     // int_sum: limbs of the plan (1..4); int64_sum: 1..8
  int32_t is_signed;   // int_sum: the plan's sign limb
  int32_t mask_idx;    // index into ScanParams.masks; entries are sorted by it
  int32_t smem_off;    // first 32-bit word of the entry's shared table
};

struct ScanParams {
  const void* key;         // codes [n] of key_type, or packed words when key_bits > 0
  const void* mask_words;  // optional uint32[n / 32] filter bitmap
  const void* pred;        // optional codes [n] of pred_type for lo <= c < hi
  const void* masks[PINOT_MAX_ENTRIES];  // distinct bool[n] masks
  int64_t n;
  int64_t head;   // rows [head, head + PINOT_WARP_ROWS * tiles) are aligned
  int64_t tiles;  // for vector loads, in tiles of PINOT_WARP_ROWS rows
  int32_t key_type;
  int32_t key_bits;  // 0: raw codes; else lanes of key_bits in uint32 words
  int32_t pred_type;
  int32_t pred_lo;
  int32_t pred_hi;
  int32_t num_groups;
  int32_t num_entries;
  int32_t num_masks;
  int32_t key_mode;    // KeyMode
  int32_t val_mode;    // ValMode
  int32_t shared;      // 1: block tables in shared memory; 0: global table
  int32_t smem_words;  // 32-bit words of the shared tables
  ScanEntry e[PINOT_MAX_ENTRIES];
};

// A thread's tile is 16 rows in 4 quads of 4 consecutive rows; quad q
// starts QS rows after quad q - 1.  Vector tiles (QS = 128) interleave the
// 32 lanes of a warp quad by quad, so each load instruction of the warp
// reads one contiguous run (512 bytes of int32 values, 128 of mask);
// scalar tiles (QS = 4) are 16 consecutive rows, of which cnt are real.
template <bool VEC>
struct Quads {
  static constexpr int QS = VEC ? 32 * 4 : 4;
  __device__ __forceinline__ static int64_t row(int64_t r0, int i) {
    return r0 + (i >> 2) * QS + (i & 3);
  }
};

// the tile's rows of an integer column of runtime type t; the type switch
// runs once a tile, not once a row
template <bool VEC>
__device__ __forceinline__ void load_ints(const void* p, int t, int64_t r0, int cnt,
                                          int64_t (&x)[PINOT_TILE]) {
#define PINOT_LOAD_AS(T)                                                          \
  {                                                                               \
    const T* q = (const T*)p;                                                     \
    _Pragma("unroll") for (int i = 0; i < PINOT_TILE; ++i) x[i] =                 \
        i < cnt ? (int64_t)q[Quads<VEC>::row(r0, i)] : 0;                         \
  }                                                                               \
  break;
  switch (t) {
    case T_U8: PINOT_LOAD_AS(uint8_t)
    case T_I8: PINOT_LOAD_AS(int8_t)
    case T_I16: PINOT_LOAD_AS(int16_t)
    case T_U16: PINOT_LOAD_AS(uint16_t)
    case T_I32: PINOT_LOAD_AS(int32_t)
    case T_U32: PINOT_LOAD_AS(uint32_t)
    default: PINOT_LOAD_AS(int64_t)
  }
#undef PINOT_LOAD_AS
}

// bit k set when byte k of w is non-zero
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  const uint32_t t = ((((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) >> 7) & 0x01010101u;
  return (t * 0x10204080u) >> 28;
}

// ---------------------------------------------------------------------------
// one tile: keys, filter bits, masks, values, adds
// ---------------------------------------------------------------------------

// group code of each row of the tile, -1 where the row is past cnt or its
// code lies outside [0, G) (out-of-table codes drop, as in the TPU kernel)
template <int KM, bool VEC>
__device__ __forceinline__ void tile_keys(const ScanParams& p, int64_t r0, int cnt,
                                          int (&code)[PINOT_TILE]) {
  constexpr int QS = Quads<VEC>::QS;
  const int G = p.num_groups;
  if constexpr (KM == KM_I32) {
    const int32_t* k = (const int32_t*)p.key + r0;
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 v = __ldg((const int4*)(k + q * QS));
        code[4 * q] = v.x, code[4 * q + 1] = v.y, code[4 * q + 2] = v.z, code[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < PINOT_TILE; ++i) code[i] = i < cnt ? k[i] : -1;
    }
#pragma unroll
    for (int i = 0; i < PINOT_TILE; ++i) code[i] = (code[i] >= 0 && code[i] < G) ? code[i] : -1;
  } else if constexpr (KM == KM_P16) {
    const uint32_t* w = (const uint32_t*)p.key;
    if constexpr (VEC) {
      // a quad is 4 lanes: a pair of words, starting on an even word
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint2 v = __ldg((const uint2*)(w + ((uint64_t)(r0 + q * QS) >> 1)));
        code[4 * q] = (int)(v.x & 0xFFFFu), code[4 * q + 1] = (int)(v.x >> 16);
        code[4 * q + 2] = (int)(v.y & 0xFFFFu), code[4 * q + 3] = (int)(v.y >> 16);
      }
    } else {
#pragma unroll
      for (int i = 0; i < PINOT_TILE; ++i) {
        if (i < cnt) {
          const uint64_t r = (uint64_t)(r0 + i);
          code[i] = (int)((__ldg(w + (r >> 1)) >> (16 * (int)(r & 1))) & 0xFFFFu);
        } else {
          code[i] = G;  // dropped below
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PINOT_TILE; ++i) code[i] = code[i] < G ? code[i] : -1;
  } else {
    if (p.key_bits > 0) {
      const uint32_t* w = (const uint32_t*)p.key;
      const int bits = p.key_bits;
      const int shift = __ffs(32 / bits) - 1;  // log2 of the lanes a word
      const int lane_mask = (32 / bits) - 1;
      const uint32_t m = (1u << bits) - 1u;
#pragma unroll
      for (int i = 0; i < PINOT_TILE; ++i) {
        if (i < cnt) {
          const int64_t r = Quads<VEC>::row(r0, i);
          const uint32_t c = (__ldg(w + (r >> shift)) >> (bits * (int)(r & lane_mask))) & m;
          code[i] = c < (uint32_t)G ? (int)c : -1;
        } else {
          code[i] = -1;
        }
      }
    } else {
      int64_t x[PINOT_TILE];
      load_ints<VEC>(p.key, p.key_type, r0, cnt, x);
#pragma unroll
      for (int i = 0; i < PINOT_TILE; ++i) code[i] = (i < cnt && x[i] >= 0 && x[i] < G) ? (int)x[i] : -1;
    }
  }
}

// bits of the tile's rows that the range-index bitmap words keep
template <bool VEC>
__device__ __forceinline__ uint32_t word_bits(const ScanParams& p, int64_t r0, int cnt) {
  const uint32_t* w = (const uint32_t*)p.mask_words;
  uint32_t b = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (4 * q >= cnt) break;
    const int64_t r = r0 + q * Quads<VEC>::QS;
    const int s = (int)(r & 31);
    uint64_t both = __ldg(w + (r >> 5));
    // the quad runs into the next word only where a row of the tile is there
    if (s > 28 && 4 * q + 32 - s < cnt) both |= (uint64_t)__ldg(w + (r >> 5) + 1) << 32;
    b |= (uint32_t)((both >> s) & 0xFu) << (4 * q);
  }
  return b;
}

// bits of the tile's rows whose predicate code lies in [lo, hi)
template <bool VEC>
__device__ __forceinline__ uint32_t pred_bits(const ScanParams& p, int64_t r0, int cnt) {
  int64_t x[PINOT_TILE];
  load_ints<VEC>(p.pred, p.pred_type, r0, cnt, x);
  uint32_t b = 0;
#pragma unroll
  for (int i = 0; i < PINOT_TILE; ++i) b |= (uint32_t)(x[i] >= p.pred_lo && x[i] < p.pred_hi) << i;
  return b;
}

template <bool VEC>
__device__ __forceinline__ uint32_t mask_bits(const uint8_t* m, int cnt) {
  if constexpr (VEC) {
    uint32_t b = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) b |= nonzero_bytes(__ldg((const uint32_t*)(m + q * Quads<VEC>::QS))) << (4 * q);
    return b;
  } else {
    uint32_t b = 0;
#pragma unroll
    for (int i = 0; i < PINOT_TILE; ++i) b |= (uint32_t)(i < cnt && m[i] != 0) << i;
    return b;
  }
}

// The value an entry adds, exactly as the Pallas kernel's limbs recombine
// it: int_sum reads the value as int32 (so uint32 wraps), keeps the low
// 8*n_limbs bits of its two's-complement pattern and, with a sign limb,
// subtracts 2^(8*n_limbs) for negatives; int64_sum keeps the low 8*n_limbs
// bits of |v| and puts the sign back.  Inside the plan's value range both
// equal v.
struct IntSumPlan {
  uint32_t keep;  // low bits of the pattern the plan keeps
  int64_t sub;    // subtracted for negatives (0 without a sign limb)
  __device__ __forceinline__ explicit IntSumPlan(const ScanEntry& en)
      : keep(en.n_limbs < 4 ? (1u << (8 * en.n_limbs)) - 1u : 0xFFFFFFFFu),
        sub(en.is_signed ? (int64_t)1 << (8 * en.n_limbs) : 0) {}
  __device__ __forceinline__ uint64_t operator()(int32_t x) const {
    return (uint64_t)((int64_t)((uint32_t)x & keep) - (x < 0 ? sub : 0));
  }
};

__device__ __forceinline__ uint64_t int64_sum_value(int64_t x, int n_limbs) {
  const bool neg = x < 0;
  uint64_t a = neg ? 0ull - (uint64_t)x : (uint64_t)x;
  if (n_limbs < 8) a &= (1ull << (8 * n_limbs)) - 1ull;
  return neg ? 0ull - a : a;
}

// exact 64-bit add into a lo/hi pair of 32-bit shared words: the carry out
// of the low word is seen by exactly the add that wraps it
__device__ __forceinline__ void shared_add64(uint32_t* lo, uint32_t* hi, uint64_t v) {
  const uint32_t l = (uint32_t)v;
  uint32_t h = (uint32_t)(v >> 32);
  if (l) {
    const uint32_t old = atomicAdd(lo, l);
    h += (uint32_t)(old + l < old);
  }
  if (h) atomicAdd(hi, h);
}

template <bool SHARED>
__device__ __forceinline__ void add_value(const ScanParams& p, const ScanEntry& en, int e,
                                          uint32_t* smem, unsigned long long* out, int g,
                                          uint64_t v) {
  if (v == 0ull) return;
  if constexpr (SHARED) {
    uint32_t* lo = smem + en.smem_off;
    shared_add64(lo + g, lo + p.num_groups + g, v);
  } else {
    atomicAdd(out + (int64_t)e * p.num_groups + g, (unsigned long long)v);
  }
}

template <int KM, int VM, bool SHARED, bool VEC>
__device__ __forceinline__ void scan_tile(const ScanParams& p, int64_t r0, int cnt, uint32_t* smem,
                                          unsigned long long* out) {
  int code[PINOT_TILE];
  tile_keys<KM, VEC>(p, r0, cnt, code);
  uint32_t valid = 0;
#pragma unroll
  for (int i = 0; i < PINOT_TILE; ++i) valid |= (uint32_t)(code[i] >= 0) << i;
  if (p.mask_words != nullptr) valid &= word_bits<VEC>(p, r0, cnt);
  if (p.pred != nullptr) valid &= pred_bits<VEC>(p, r0, cnt);
  if (!valid) return;
  const int E = p.num_entries;
  int e = 0;
  for (int m = 0; m < p.num_masks; ++m) {
    const uint32_t bits = valid & mask_bits<VEC>((const uint8_t*)p.masks[m] + r0, cnt);
    for (; e < E && p.e[e].mask_idx == m; ++e) {
      if (!bits) continue;
      const ScanEntry& en = p.e[e];
      if (en.kind == K_COUNT) {
#pragma unroll
        for (int i = 0; i < PINOT_TILE; ++i) {
          if (!((bits >> i) & 1u)) continue;
          if constexpr (SHARED) {
            atomicAdd(smem + en.smem_off + code[i], 1u);
          } else {
            atomicAdd(out + (int64_t)e * p.num_groups + code[i], 1ull);
          }
        }
      } else if constexpr (VM == VM_I32) {
        // every sum entry is int_sum over 4-byte values
        int32_t x[PINOT_TILE];
        const int32_t* src = (const int32_t*)en.values + r0;
        if constexpr (VEC) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int4 v = __ldg((const int4*)(src + q * Quads<VEC>::QS));
            x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < PINOT_TILE; ++i) x[i] = ((bits >> i) & 1u) ? src[i] : 0;
        }
        const IntSumPlan plan(en);
#pragma unroll
        for (int i = 0; i < PINOT_TILE; ++i)
          if ((bits >> i) & 1u) add_value<SHARED>(p, en, e, smem, out, code[i], plan(x[i]));
      } else {
        int64_t x[PINOT_TILE];
        load_ints<VEC>(en.values, en.vtype, r0, cnt, x);
        if (en.kind == K_INT_SUM) {
          const IntSumPlan plan(en);
#pragma unroll
          for (int i = 0; i < PINOT_TILE; ++i)
            if ((bits >> i) & 1u) add_value<SHARED>(p, en, e, smem, out, code[i], plan((int32_t)x[i]));
        } else {
#pragma unroll
          for (int i = 0; i < PINOT_TILE; ++i)
            if ((bits >> i) & 1u)
              add_value<SHARED>(p, en, e, smem, out, code[i], int64_sum_value(x[i], en.n_limbs));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// one block's share of one launch's rows: block `blk` of `nblk` blocks
// scans its tiles into its shared tables and flushes them into out
template <int KM, int VM, bool SHARED>
__device__ __forceinline__ void scan_rows(const ScanParams& p, unsigned long long* __restrict__ out,
                                          uint32_t* smem, int64_t blk, int64_t nblk) {
  if constexpr (SHARED) {
    for (int i = threadIdx.x; i < p.smem_words; i += blockDim.x) smem[i] = 0u;
    __syncthreads();
  }
  const int64_t nthreads = nblk * blockDim.x;
  const int64_t tid = blk * blockDim.x + threadIdx.x;
  // vector tiles: a warp takes PINOT_WARP_ROWS rows a step
  for (int64_t t = tid >> 5; t < p.tiles; t += nthreads >> 5)
    scan_tile<KM, VM, SHARED, true>(p, p.head + t * PINOT_WARP_ROWS + (threadIdx.x & 31) * 4,
                                    PINOT_TILE, smem, out);
  // scalar tiles: t == 0 is the head [0, head), then the tail in 16s
  const int64_t tail0 = p.head + p.tiles * PINOT_WARP_ROWS;
  const int64_t scalar_tiles = 1 + (p.n - tail0 + PINOT_TILE - 1) / PINOT_TILE;
  for (int64_t t = nthreads - 1 - tid; t < scalar_tiles; t += nthreads) {
    const int64_t r0 = t == 0 ? 0 : tail0 + (t - 1) * PINOT_TILE;
    const int64_t left = t == 0 ? p.head : p.n - r0;
    const int cnt = (int)(left < PINOT_TILE ? left : PINOT_TILE);
    if (cnt > 0) scan_tile<KM, VM, SHARED, false>(p, r0, cnt, smem, out);
  }
  if constexpr (SHARED) {
    // one global atomic per non-zero slot of the block's tables
    __syncthreads();
    const int G = p.num_groups;
    for (int e = 0; e < p.num_entries; ++e) {
      const ScanEntry& en = p.e[e];
      const uint32_t* t = smem + en.smem_off;
      for (int g = threadIdx.x; g < G; g += blockDim.x) {
        const uint64_t v = en.kind == K_COUNT ? (uint64_t)t[g] : ((uint64_t)t[G + g] << 32 | t[g]);
        if (v != 0ull) atomicAdd(out + (int64_t)e * G + g, (unsigned long long)v);
      }
    }
  }
}

template <int KM, int VM, bool SHARED>
__global__ void __launch_bounds__(PINOT_BLOCK, PINOT_MIN_BLOCKS_PER_SM)
fused_scan_kernel(const __grid_constant__ ScanParams p, unsigned long long* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  scan_rows<KM, VM, SHARED>(p, out, smem, blockIdx.x, gridDim.x);
}

// W members' launches in one grid: member blockIdx.y, its tables at
// out + blockIdx.y * out_stride
struct ScanBatch {
  ScanParams m[PINOT_MAX_MEMBERS];
};

template <int KM, int VM, bool SHARED>
__global__ void __launch_bounds__(PINOT_BLOCK, PINOT_MIN_BLOCKS_PER_SM)
fused_scan_batch_kernel(const __grid_constant__ ScanBatch b, unsigned long long* __restrict__ out,
                        int64_t out_stride) {
  extern __shared__ uint32_t smem[];
  scan_rows<KM, VM, SHARED>(b.m[blockIdx.y], out + blockIdx.y * out_stride, smem, blockIdx.x, gridDim.x);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef void (*ScanKernel)(const ScanParams, unsigned long long*);
typedef void (*BatchKernel)(const ScanBatch, unsigned long long*, int64_t);

// the four instantiations (ops/fused_scan.py: INSTANTIATIONS), unbatched
// and with the member axis
#define PINOT_PICK(KERNEL)                                                           \
  if (km == KM_ANY && vm == VM_ANY) return shared ? KERNEL<KM_ANY, VM_ANY, true>     \
                                                  : KERNEL<KM_ANY, VM_ANY, false>;   \
  if (!shared || vm != VM_I32) return nullptr;                                       \
  if (km == KM_I32) return KERNEL<KM_I32, VM_I32, true>;                             \
  if (km == KM_P16) return KERNEL<KM_P16, VM_I32, true>;                             \
  return nullptr;

static ScanKernel pick_kernel(int km, int vm, int shared) { PINOT_PICK(fused_scan_kernel) }
static BatchKernel pick_batch_kernel(int km, int vm, int shared) { PINOT_PICK(fused_scan_batch_kernel) }
#undef PINOT_PICK

// what a launch of one instantiation may use, computed once
struct LaunchPlan {
  int dev;
  const void* fn;
  int smem;
  int max_blocks;  // co-resident blocks on the card
};

static std::mutex g_mu;
static LaunchPlan g_plans[256];
static int g_num_plans = 0;

static cudaError_t launch_plan(int dev, const void* fn, int smem, LaunchPlan* out) {
  std::lock_guard<std::mutex> lock(g_mu);
  for (int i = 0; i < g_num_plans; ++i) {
    const LaunchPlan& c = g_plans[i];
    if (c.dev == dev && c.fn == fn && c.smem == smem) {
      *out = c;
      return cudaSuccess;
    }
  }
  int sms = 0, optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  // the attribute belongs to the function, not to this plan: set it to the
  // opt-in once, so that no plan lowers it under another plan's size
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, PINOT_BLOCK, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const LaunchPlan c = {dev, fn, smem, sms * per_sm};
  if (g_num_plans < (int)(sizeof(g_plans) / sizeof(g_plans[0]))) g_plans[g_num_plans++] = c;
  *out = c;
  return cudaSuccess;
}

static bool params_ok(const ScanParams* p) {
  return p->num_entries >= 1 && p->num_entries <= PINOT_MAX_ENTRIES && p->num_groups >= 1 && p->n >= 0 &&
         p->num_masks >= 1 && p->num_masks <= p->num_entries && p->head >= 0 && p->tiles >= 0 &&
         p->head + p->tiles * PINOT_WARP_ROWS <= p->n;
}

// threads one launch needs: a warp a vector tile, a thread a scalar tile
static int64_t threads_needed(const ScanParams* p) {
  return p->tiles * 32 + 2 + (p->n - p->head - p->tiles * PINOT_WARP_ROWS) / PINOT_TILE;
}

extern "C" {

// out: zeroed int64[num_entries, num_groups] on the current device.
int pinot_fused_scan(const ScanParams* p, void* out, void* stream) {
  if (!params_ok(p)) return (int)cudaErrorInvalidValue;
  const ScanKernel fn = pick_kernel(p->key_mode, p->val_mode, p->shared);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (p->n == 0) return (int)cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int smem = p->shared ? p->smem_words * (int)sizeof(uint32_t) : 0;
  LaunchPlan plan;
  err = launch_plan(dev, (const void*)fn, smem, &plan);
  if (err != cudaSuccess) return (int)err;
  int64_t grid = (threads_needed(p) + PINOT_BLOCK - 1) / PINOT_BLOCK;
  if (grid > plan.max_blocks) grid = plan.max_blocks;
  // a block's 32-bit counters hold fewer than 2^32 rows (2^31 leaves room
  // for the uneven split of tiles between blocks)
  if (p->shared && p->n / grid >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  fn<<<(unsigned)grid, PINOT_BLOCK, smem, (cudaStream_t)stream>>>(*p, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

// ps: `members` launches' params, one instantiation (key mode, value mode,
// shared) and one table shape (entries, groups) for all; out: zeroed
// int64[members, num_entries, num_groups] on the current device.  The
// co-resident blocks split evenly between the members.
int pinot_fused_scan_batch(const ScanParams* ps, int members, void* out, void* stream) {
  if (members < 1 || members > PINOT_MAX_MEMBERS) return (int)cudaErrorInvalidValue;
  ScanBatch b;
  int64_t threads = 0, n_max = 0;
  int smem_words = 0;
  for (int w = 0; w < members; ++w) {
    const ScanParams* p = ps + w;
    if (!params_ok(p) || p->key_mode != ps->key_mode || p->val_mode != ps->val_mode ||
        p->shared != ps->shared || p->num_entries != ps->num_entries || p->num_groups != ps->num_groups)
      return (int)cudaErrorInvalidValue;
    b.m[w] = *p;
    const int64_t t = threads_needed(p);
    threads = t > threads ? t : threads;
    n_max = p->n > n_max ? p->n : n_max;
    smem_words = p->smem_words > smem_words ? p->smem_words : smem_words;
  }
  const BatchKernel fn = pick_batch_kernel(ps->key_mode, ps->val_mode, ps->shared);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (n_max == 0) return (int)cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int smem = ps->shared ? smem_words * (int)sizeof(uint32_t) : 0;
  LaunchPlan plan;
  err = launch_plan(dev, (const void*)fn, smem, &plan);
  if (err != cudaSuccess) return (int)err;
  int64_t grid = (threads + PINOT_BLOCK - 1) / PINOT_BLOCK;
  const int64_t per_member = plan.max_blocks / members > 0 ? plan.max_blocks / members : 1;
  if (grid > per_member) grid = per_member;
  if (ps->shared && n_max / grid >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const dim3 blocks((unsigned)grid, (unsigned)members);
  fn<<<blocks, PINOT_BLOCK, smem, (cudaStream_t)stream>>>(
      b, (unsigned long long*)out, (int64_t)ps->num_entries * ps->num_groups);
  return (int)cudaGetLastError();
}

int pinot_fused_scan_max_members(void) { return PINOT_MAX_MEMBERS; }

int pinot_fused_scan_params_size(void) { return (int)sizeof(ScanParams); }

int pinot_device_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

const char* pinot_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
