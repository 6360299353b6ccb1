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
// a stacked one member w's slice), and all W ride one kernel parameter
// block (ScanBatch, within the 32 KB parameter space of CUDA 12.1+ on
// sm_90a) behind a header that says which operands every member shares
// (the key, the filter words, the predicate codes, each distinct mask,
// each entry's values) and how many members Wg one block scans together.
// What bounds it: the shared streams' bytes once, each member's own bytes,
// then W times the shared-memory adds of one launch.  The design:
// - Member groups sized by shared memory.  Where every member reads one
//   shared key in a specialised instantiation (every member-axis launch of
//   the SQL path), Wg = min(W, opt-in / one member's table bytes) (8 at
//   E = 2, G = 2406: 230,976 of 232,448 B); the grid is (x, ceil(W / Wg)),
//   so each shared stream is read ceil(W / Wg) times, not W times.  Every
//   other launch (a stacked key, the generic instantiation, tables that
//   fill a block, the global-table path) has Wg = 1: each grid row is one
//   member's launch of the unbatched tile code.
// - One block, every member of its group.  A block reads a tile's shared
//   key, words, predicate codes, masks and values once, builds each
//   member's row bits from its own words, code range and masks (shared
//   codes that fit in int32 are read once, each member's range one 32-bit
//   compare a row; uint32 or int64 codes, and stacked ones, each member
//   reads and compares itself), and adds into member w's tables at
//   smem + w * smem_words.  The block's 1024 threads leave 64 registers a
//   thread, so a thread takes its 16 rows as two half tiles of 8 (two
//   quads), the members' row bits packed a byte each (two registers for
//   eight members) and picked by member under a loop that is not unrolled.
// - What binds then is W times one launch's shared-memory adds and the
//   instructions around them (PERF.md, member_phases.py).  Each row's table
//   offset and value words are worked out once for all members; a sum's 8
//   low-word atomics are issued before their returns are read for the
//   carries, and a half tile's high words are added only where a row
//   carried or has a high word of its own.  Otherwise the tile keeps the
//   design above (quads, scalar head and tail, one read per distinct mask,
//   32-bit shared atomics with an exact carry, one persistent block a
//   multiprocessor).
// - The flush grows with the group: Wg tables a block, one global atomic
//   per non-zero slot, the slots spread over all the block's threads.
// The wrapper (ops/fused_scan.py: batch_layout, vmap_batch) works out the
// shared operands and Wg; the launch checks that the members of a group
// read the same rows with the same entries.

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

// ---------------------------------------------------------------------------
// the member axis
// ---------------------------------------------------------------------------
// operands that are one address for every member of a launch
// (BatchHeader.shared)
#define PINOT_SH_KEY 1u
#define PINOT_SH_WORDS 2u
#define PINOT_SH_PRED 4u

struct BatchHeader {
  int32_t members;         // W
  int32_t group;           // Wg: members one block scans together
  uint32_t shared;         // PINOT_SH_* bits
  uint32_t masks_shared;   // bit j: distinct mask j is one address for every member
  uint32_t values_shared;  // bit e: entry e's values are one address for every member
  int32_t unused;
};

// W members' launches in one grid: the members in groups of h.group, group
// blockIdx.y; member w's tables at out + w * out_stride
struct ScanBatch {
  BatchHeader h;
  ScanParams m[PINOT_MAX_MEMBERS];
};

// The member path works on half tiles: 8 of a thread's 16 rows, quads 2h
// and 2h + 1 of a vector tile (r0h = r0 + 2h * 128) or rows 8h .. 8h + 7 of
// a scalar one (r0h = r0 + 8h), so that codes, values and row bits take
// half the registers; row i of a half tile is Quads<VEC>::row(r0h, i).
#define PINOT_HALF 8

// codes of a half tile's rows, -1 past cnt or outside [0, G)
template <int KM, bool VEC>
__device__ __forceinline__ void half_keys(const ScanParams& p, int64_t r0h, int cnt, int (&code)[PINOT_HALF]) {
  constexpr int QS = Quads<VEC>::QS;
  const int G = p.num_groups;
  if constexpr (KM == KM_I32) {
    const int32_t* k = (const int32_t*)p.key + r0h;
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int4 v = __ldg((const int4*)(k + q * QS));
        code[4 * q] = v.x, code[4 * q + 1] = v.y, code[4 * q + 2] = v.z, code[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < PINOT_HALF; ++i) code[i] = i < cnt ? k[i] : -1;
    }
#pragma unroll
    for (int i = 0; i < PINOT_HALF; ++i) code[i] = (code[i] >= 0 && code[i] < G) ? code[i] : -1;
  } else {
    static_assert(KM == KM_P16, "the member path takes the specialised keys");
    const uint32_t* w = (const uint32_t*)p.key;
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint2 v = __ldg((const uint2*)(w + ((uint64_t)(r0h + q * QS) >> 1)));
        code[4 * q] = (int)(v.x & 0xFFFFu), code[4 * q + 1] = (int)(v.x >> 16);
        code[4 * q + 2] = (int)(v.y & 0xFFFFu), code[4 * q + 3] = (int)(v.y >> 16);
      }
    } else {
#pragma unroll
      for (int i = 0; i < PINOT_HALF; ++i) {
        const uint64_t r = (uint64_t)(r0h + i);
        code[i] = i < cnt ? (int)((__ldg(w + (r >> 1)) >> (16 * (int)(r & 1))) & 0xFFFFu) : G;
      }
    }
#pragma unroll
    for (int i = 0; i < PINOT_HALF; ++i) code[i] = code[i] < G ? code[i] : -1;
  }
}

// bits of a half tile's rows whose mask byte is non-zero (m: the mask at r0h)
template <bool VEC>
__device__ __forceinline__ uint32_t half_mask(const uint8_t* m, int cnt) {
  if constexpr (VEC) {
    return nonzero_bytes(__ldg((const uint32_t*)m)) |
           nonzero_bytes(__ldg((const uint32_t*)(m + Quads<VEC>::QS))) << 4;
  } else {
    uint32_t b = 0;
#pragma unroll
    for (int i = 0; i < PINOT_HALF; ++i) b |= (uint32_t)(i < cnt && m[i] != 0) << i;
    return b;
  }
}

// a half tile's int32 values: vector loads, or the rows of `rows` one by one
template <bool VEC>
__device__ __forceinline__ void half_values(const void* values, int64_t r0h, uint32_t rows,
                                            int32_t (&x)[PINOT_HALF]) {
  const int32_t* src = (const int32_t*)values + r0h;
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int4 v = __ldg((const int4*)(src + q * Quads<VEC>::QS));
      x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < PINOT_HALF; ++i) x[i] = ((rows >> i) & 1u) ? src[i] : 0;
  }
}

// A half tile's row bits for up to 8 members, 8 bits a member: member w's
// in byte w & 3 of word w >> 2.  get() and keep() select without indexing
// by w, so the words stay in registers under a loop over members that is
// not unrolled.
struct MemberBits {
  uint32_t h[2];
  __device__ __forceinline__ uint32_t get(int w) const { return ((w & 4 ? h[1] : h[0]) >> (8 * (w & 3))) & 0xFFu; }
  __device__ __forceinline__ bool any() const { return (h[0] | h[1]) != 0u; }
  __device__ __forceinline__ void keep(int w, uint32_t bits) {
    const uint32_t k = ~((~bits & 0xFFu) << (8 * (w & 3)));
    h[0] &= w & 4 ? 0xFFFFFFFFu : k;
    h[1] &= w & 4 ? k : 0xFFFFFFFFu;
  }
};

// bits of a half tile's rows whose predicate code lies in p's [lo, hi):
// the codes' type switch once a half tile, and codes that fit in int32
// compared in 32 bits (lo <= x < hi as the unsigned x - lo < hi - lo)
template <bool VEC>
__device__ __forceinline__ uint32_t half_pred(const ScanParams& p, int64_t r0h, int cnt) {
  const int64_t lo = p.pred_lo, hi = p.pred_hi;
  const uint32_t lo32 = (uint32_t)p.pred_lo, span32 = hi > lo ? (uint32_t)(hi - lo) : 0u;
  uint32_t b = 0;
#define PINOT_PRED_AS(T)                                                                      \
  {                                                                                           \
    constexpr bool narrow = sizeof(T) < 4 || (sizeof(T) == 4 && (T)(-1) < (T)0);             \
    const T* q = (const T*)p.pred;                                                            \
    _Pragma("unroll") for (int i = 0; i < PINOT_HALF; ++i) if (i < cnt) {                     \
      const T x = q[Quads<VEC>::row(r0h, i)];                                                 \
      b |= (uint32_t)(narrow ? (uint32_t)(int32_t)x - lo32 < span32                           \
                             : (int64_t)x >= lo && (int64_t)x < hi) << i;                     \
    }                                                                                         \
  }                                                                                           \
  break;
  switch (p.pred_type) {
    case T_U8: PINOT_PRED_AS(uint8_t)
    case T_I8: PINOT_PRED_AS(int8_t)
    case T_I16: PINOT_PRED_AS(int16_t)
    case T_U16: PINOT_PRED_AS(uint16_t)
    case T_I32: PINOT_PRED_AS(int32_t)
    case T_U32: PINOT_PRED_AS(uint32_t)
    default: PINOT_PRED_AS(int64_t)
  }
#undef PINOT_PRED_AS
  return b;
}

// a half tile's codes of a type that fits in int32, as int32 (the type
// switch once a half tile; rows past cnt read as 0); false for uint32 and
// int64 codes, which half_pred compares in 64 bits
template <bool VEC>
__device__ __forceinline__ bool half_codes32(const ScanParams& p, int64_t r0h, int cnt, int32_t (&x)[PINOT_HALF]) {
#define PINOT_CODES_AS(T)                                                                                  \
  {                                                                                                        \
    const T* q = (const T*)p.pred;                                                                         \
    _Pragma("unroll") for (int i = 0; i < PINOT_HALF; ++i) x[i] = i < cnt ? (int32_t)q[Quads<VEC>::row(r0h, i)] : 0; \
  }                                                                                                        \
  return true;
  switch (p.pred_type) {
    case T_U8: PINOT_CODES_AS(uint8_t)
    case T_I8: PINOT_CODES_AS(int8_t)
    case T_I16: PINOT_CODES_AS(int16_t)
    case T_U16: PINOT_CODES_AS(uint16_t)
    case T_I32: PINOT_CODES_AS(int32_t)
    default: return false;
  }
#undef PINOT_CODES_AS
}

// predicated shared-memory adds at a shared-space address: the row's bit
// is the predicate, so no row takes a branch of its own
__device__ __forceinline__ void red_shared_if(uint32_t addr, uint32_t v, uint32_t on) {
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t@p red.shared.add.u32 [%0], %1;\n\t}"
               :: "r"(addr), "r"(v), "r"(on) : "memory");
}

// the same with the word's old value returned (0 where the row is off)
__device__ __forceinline__ uint32_t atom_shared_if(uint32_t addr, uint32_t v, uint32_t on) {
  uint32_t old = 0u;
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\t@p atom.shared.add.u32 %0, [%1], %2;\n\t}"
               : "+r"(old) : "r"(addr), "r"(v), "r"(on) : "memory");
  return old;
}

// a half tile's int_sum values as the low and high words of what each row
// adds (IntSumPlan); returns the rows whose high word is not zero
__device__ __forceinline__ uint32_t split_values(const IntSumPlan& plan, const int32_t (&x)[PINOT_HALF],
                                                 uint32_t (&lo)[PINOT_HALF], uint32_t (&hi)[PINOT_HALF]) {
  uint32_t high = 0;
#pragma unroll
  for (int i = 0; i < PINOT_HALF; ++i) {
    const uint64_t v = plan(x[i]);
    lo[i] = (uint32_t)v, hi[i] = (uint32_t)(v >> 32);
    high |= (uint32_t)(hi[i] != 0u) << i;
  }
  return high;
}

// One half tile for the ng members of a group whose key is shared, in the
// specialised instantiations: the block reads the key, the shared words,
// the shared predicate codes (those that fit in int32), each shared mask
// and each shared entry's values once; each member's row bits come from its
// own words, code range and masks; the adds go into member w's tables at
// smem + w * stride.  Each
// row's table offset and value words are worked out once for all members;
// a member's adds are predicated on its row bits, and a sum's 8 low-word
// atomics are issued before their returns are read for the carries (the
// exact 64-bit add of shared_add64).  Entries, masks and the instantiation
// are the same for every member (the launch checks), so member 0's entries
// describe them all.
template <int KM, bool VEC>
__device__ __forceinline__ void scan_half_members(const ScanBatch& b, int w0, int ng, int64_t r0h, int cnt,
                                                  uint32_t* smem, int stride) {
  const ScanParams& p0 = b.m[w0];
  const uint32_t sh = b.h.shared;
  // 1. each member's words and code range
  MemberBits vb = {{0u, 0u}};
#pragma unroll
  for (int w = 0; w < PINOT_MAX_MEMBERS; ++w) {
    if (w >= ng) break;
    uint32_t bits = 0xFFu;
    if (p0.mask_words != nullptr && !(sh & PINOT_SH_WORDS)) bits &= word_bits<VEC>(b.m[w0 + w], r0h, cnt);
    vb.h[w >> 2] |= (bits & 0xFFu) << (8 * (w & 3));
  }
  if (p0.pred != nullptr) {
    int32_t x[PINOT_HALF];
    if ((sh & PINOT_SH_PRED) && half_codes32<VEC>(p0, r0h, cnt, x)) {
      // shared codes read once, each member's range compared in 32 bits
#pragma unroll 1
      for (int w = 0; w < ng; ++w) {
        const ScanParams& p = b.m[w0 + w];
        const uint32_t lo = (uint32_t)p.pred_lo;
        const uint32_t span = p.pred_hi > p.pred_lo ? (uint32_t)((int64_t)p.pred_hi - p.pred_lo) : 0u;
        uint32_t pb = 0;
#pragma unroll
        for (int i = 0; i < PINOT_HALF; ++i) pb |= (uint32_t)((uint32_t)x[i] - lo < span) << i;
        vb.keep(w, pb);
      }
    } else {
#pragma unroll 1
      for (int w = 0; w < ng; ++w) vb.keep(w, half_pred<VEC>(b.m[w0 + w], r0h, cnt));
    }
  }
  // 2. the shared key, and the shared words
  uint32_t c4[PINOT_HALF];  // each row's word offset in a table (4 * its code)
  uint32_t base = 0;
  {
    int code[PINOT_HALF];
    half_keys<KM, VEC>(p0, r0h, cnt, code);
#pragma unroll
    for (int i = 0; i < PINOT_HALF; ++i) {
      base |= (uint32_t)(code[i] >= 0) << i;
      c4[i] = 4u * (uint32_t)code[i];
    }
  }
  if (p0.mask_words != nullptr && (sh & PINOT_SH_WORDS)) base &= word_bits<VEC>(p0, r0h, cnt);
  base = (base & 0xFFu) * 0x01010101u;
  vb.h[0] &= base, vb.h[1] &= base;
  if (!vb.any()) return;
  // 3. per distinct mask: each member's bits, then its entries' adds
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const int G = p0.num_groups;
  const int E = p0.num_entries;
  int e = 0;
  for (int m = 0; m < p0.num_masks; ++m) {
    MemberBits mb = {{0u, 0u}};
    if ((b.h.masks_shared >> m) & 1u) {
      const uint32_t sm = half_mask<VEC>((const uint8_t*)p0.masks[m] + r0h, cnt) * 0x01010101u;
      mb.h[0] = vb.h[0] & sm, mb.h[1] = vb.h[1] & sm;
    } else {
#pragma unroll
      for (int w = 0; w < PINOT_MAX_MEMBERS; ++w) {
        if (w >= ng) break;
        mb.h[w >> 2] |= half_mask<VEC>((const uint8_t*)b.m[w0 + w].masks[m] + r0h, cnt) << (8 * (w & 3));
      }
      mb.h[0] &= vb.h[0], mb.h[1] &= vb.h[1];
    }
    const bool any = mb.any();
    for (; e < E && p0.e[e].mask_idx == m; ++e) {
      if (!any) continue;
      const ScanEntry& en = p0.e[e];
      if (en.kind == K_COUNT) {
#pragma unroll 1
        for (int w = 0; w < ng; ++w) {
          const uint32_t bits = mb.get(w);
          const uint32_t t = sbase + 4u * (uint32_t)(w * stride + en.smem_off);
#pragma unroll
          for (int i = 0; i < PINOT_HALF; ++i) red_shared_if(t + c4[i], 1u, bits & (1u << i));
        }
        continue;
      }
      // every sum entry is int_sum over 4-byte values
      const bool values_once = (b.h.values_shared >> e) & 1u;
      const IntSumPlan plan(en);
      uint32_t vlo[PINOT_HALF], vhi[PINOT_HALF], high = 0;
      if (values_once) {
        const uint32_t rows = mb.h[0] | mb.h[1];
        int32_t x[PINOT_HALF];
        half_values<VEC>(en.values, r0h, (rows | rows >> 8 | rows >> 16 | rows >> 24) & 0xFFu, x);
        high = split_values(plan, x, vlo, vhi);
      }
#pragma unroll 1
      for (int w = 0; w < ng; ++w) {
        const uint32_t bits = mb.get(w);
        if (!bits) continue;
        if (!values_once) {
          int32_t x[PINOT_HALF];
          half_values<VEC>(b.m[w0 + w].e[e].values, r0h, bits, x);
          high = split_values(plan, x, vlo, vhi);
        }
        const uint32_t lo = sbase + 4u * (uint32_t)(w * stride + en.smem_off);
        uint32_t old[PINOT_HALF];
#pragma unroll
        for (int i = 0; i < PINOT_HALF; ++i) old[i] = atom_shared_if(lo + c4[i], vlo[i], bits & (1u << i));
        // the high words: the rows that carried out of a low word, or add
        // a high word of their own (rare: a row's value is under 2^32 and
        // not negative on the SQL path)
        uint32_t carry = 0;
#pragma unroll
        for (int i = 0; i < PINOT_HALF; ++i) carry |= (uint32_t)(old[i] + vlo[i] < old[i]) << i;
        if ((carry | high) & bits) {
          const uint32_t hi = lo + 4u * (uint32_t)G;
#pragma unroll
          for (int i = 0; i < PINOT_HALF; ++i) {
            const uint32_t h = vhi[i] + ((carry >> i) & 1u);
            red_shared_if(hi + c4[i], h, (bits >> i) & 1u & (uint32_t)(h != 0u));
          }
        }
      }
    }
  }
}

// a tile's two half tiles for the members of a group
template <int KM, bool VEC>
__device__ __forceinline__ void scan_tile_members(const ScanBatch& b, int w0, int ng, int64_t r0, int cnt,
                                                  uint32_t* smem, int stride) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t r0h = VEC ? r0 + 2 * h * Quads<VEC>::QS : r0 + PINOT_HALF * h;
    const int left = cnt - PINOT_HALF * h;
    const int c = left < PINOT_HALF ? left : PINOT_HALF;
    if (c > 0) scan_half_members<KM, VEC>(b, w0, ng, r0h, c, smem, stride);
  }
}

// one block's share of a group's rows (a shared key, a specialised
// instantiation): its tiles for every member of the group into the
// members' shared tables, side by side, then one global atomic per
// non-zero slot of each
template <int KM>
__device__ __forceinline__ void scan_rows_members(const ScanBatch& b, int w0, int ng,
                                                  unsigned long long* __restrict__ out, int64_t out_stride,
                                                  uint32_t* smem, int64_t blk, int64_t nblk) {
  const ScanParams& p0 = b.m[w0];
  const int stride = p0.smem_words;
  for (int i = threadIdx.x; i < ng * stride; i += blockDim.x) smem[i] = 0u;
  __syncthreads();
  const int64_t nthreads = nblk * blockDim.x;
  const int64_t tid = blk * blockDim.x + threadIdx.x;
  for (int64_t t = tid >> 5; t < p0.tiles; t += nthreads >> 5)
    scan_tile_members<KM, true>(b, w0, ng, p0.head + t * PINOT_WARP_ROWS + (threadIdx.x & 31) * 4, PINOT_TILE,
                                smem, stride);
  const int64_t tail0 = p0.head + p0.tiles * PINOT_WARP_ROWS;
  const int64_t scalar_tiles = 1 + (p0.n - tail0 + PINOT_TILE - 1) / PINOT_TILE;
  for (int64_t t = nthreads - 1 - tid; t < scalar_tiles; t += nthreads) {
    const int64_t r0 = t == 0 ? 0 : tail0 + (t - 1) * PINOT_TILE;
    const int64_t left = t == 0 ? p0.head : p0.n - r0;
    const int cnt = (int)(left < PINOT_TILE ? left : PINOT_TILE);
    if (cnt > 0) scan_tile_members<KM, false>(b, w0, ng, r0, cnt, smem, stride);
  }
  __syncthreads();
  const int G = p0.num_groups;
  const int EG = p0.num_entries * G;
  for (int i = threadIdx.x; i < ng * EG; i += blockDim.x) {
    const int w = i / EG;
    const int e = (i - w * EG) / G;
    const int g = i - w * EG - e * G;
    const uint32_t* t = smem + w * stride + p0.e[e].smem_off;
    const uint64_t v = p0.e[e].kind == K_COUNT ? (uint64_t)t[g] : ((uint64_t)t[G + g] << 32 | t[g]);
    if (v != 0ull) atomicAdd(out + (int64_t)(w0 + w) * out_stride + (int64_t)e * G + g, (unsigned long long)v);
  }
}

template <int KM, int VM, bool SHARED>
__global__ void __launch_bounds__(PINOT_BLOCK, PINOT_MIN_BLOCKS_PER_SM)
fused_scan_batch_kernel(const __grid_constant__ ScanBatch b, unsigned long long* __restrict__ out,
                        int64_t out_stride) {
  extern __shared__ uint32_t smem[];
  const int w0 = blockIdx.y * b.h.group;
  const int left = b.h.members - w0;
  const int ng = left < b.h.group ? left : b.h.group;
  if constexpr (SHARED && KM != KM_ANY && VM == VM_I32) {
    if (ng > 1) {
      scan_rows_members<KM>(b, w0, ng, out, out_stride, smem, blockIdx.x, gridDim.x);
      return;
    }
  }
  scan_rows<KM, VM, SHARED>(b.m[w0], out + w0 * out_stride, smem, blockIdx.x, gridDim.x);
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

// members that one block scans together read the same rows (n, head,
// tiles), have the same entries and masks, and agree with the header's
// shared flags (a shared operand is one address for every member)
static bool same_rows_and_entries(const ScanParams* a, const ScanParams* p, const BatchHeader* h) {
  if (p->n != a->n || p->head != a->head || p->tiles != a->tiles || p->key_type != a->key_type ||
      p->key_bits != a->key_bits || p->pred_type != a->pred_type || p->num_masks != a->num_masks ||
      (p->mask_words == nullptr) != (a->mask_words == nullptr) || (p->pred == nullptr) != (a->pred == nullptr))
    return false;
  if ((h->shared & PINOT_SH_KEY) && p->key != a->key) return false;
  if ((h->shared & PINOT_SH_WORDS) && p->mask_words != a->mask_words) return false;
  if ((h->shared & PINOT_SH_PRED) && p->pred != a->pred) return false;
  for (int j = 0; j < a->num_masks; ++j)
    if (((h->masks_shared >> j) & 1u) && p->masks[j] != a->masks[j]) return false;
  for (int e = 0; e < a->num_entries; ++e) {
    const ScanEntry &x = a->e[e], &y = p->e[e];
    if (x.kind != y.kind || x.vtype != y.vtype || x.n_limbs != y.n_limbs || x.is_signed != y.is_signed ||
        x.mask_idx != y.mask_idx || x.smem_off != y.smem_off)
      return false;
    if (((h->values_shared >> e) & 1u) && x.values != y.values) return false;
  }
  return true;
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

// b: W = b->h.members launches' params, one instantiation (key mode, value
// mode, shared) and one table shape (entries, groups) for all, in groups of
// Wg = b->h.group members a block; out: zeroed int64[W, num_entries,
// num_groups] on the current device.  The grid is (x, ceil(W / Wg)): the
// co-resident blocks split evenly between the groups, and a block of a
// group of Wg > 1 holds the Wg members' tables side by side.
int pinot_fused_scan_batch(const ScanBatch* b, void* out, void* stream) {
  const int W = b->h.members, Wg = b->h.group;
  if (W < 1 || W > PINOT_MAX_MEMBERS || Wg < 1 || Wg > W) return (int)cudaErrorInvalidValue;
  const ScanParams* ps = b->m;
  // a group of several members reads one shared key in a specialised
  // instantiation; every other launch takes one member a grid row
  if (Wg > 1 && !(ps->shared && ps->key_mode != KM_ANY && ps->val_mode == VM_I32 && (b->h.shared & PINOT_SH_KEY)))
    return (int)cudaErrorInvalidValue;
  int64_t threads = 0, n_max = 0;
  for (int w = 0; w < W; ++w) {
    const ScanParams* p = ps + w;
    if (!params_ok(p) || p->key_mode != ps->key_mode || p->val_mode != ps->val_mode ||
        p->shared != ps->shared || p->num_entries != ps->num_entries || p->num_groups != ps->num_groups ||
        p->smem_words != ps->smem_words)
      return (int)cudaErrorInvalidValue;
    if (Wg > 1 && !same_rows_and_entries(ps, p, &b->h)) return (int)cudaErrorInvalidValue;
    const int64_t t = threads_needed(p);
    threads = t > threads ? t : threads;
    n_max = p->n > n_max ? p->n : n_max;
  }
  const BatchKernel fn = pick_batch_kernel(ps->key_mode, ps->val_mode, ps->shared);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (n_max == 0) return (int)cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int smem = ps->shared ? Wg * ps->smem_words * (int)sizeof(uint32_t) : 0;
  LaunchPlan plan;
  err = launch_plan(dev, (const void*)fn, smem, &plan);
  if (err != cudaSuccess) return (int)err;
  const int groups = (W + Wg - 1) / Wg;
  int64_t grid = (threads + PINOT_BLOCK - 1) / PINOT_BLOCK;
  const int64_t per_group = plan.max_blocks / groups > 0 ? plan.max_blocks / groups : 1;
  if (grid > per_group) grid = per_group;
  if (ps->shared && n_max / grid >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  const dim3 blocks((unsigned)grid, (unsigned)groups);
  fn<<<blocks, PINOT_BLOCK, smem, (cudaStream_t)stream>>>(
      *b, (unsigned long long*)out, (int64_t)ps->num_entries * ps->num_groups);
  return (int)cudaGetLastError();
}

int pinot_fused_scan_max_members(void) { return PINOT_MAX_MEMBERS; }

int pinot_fused_scan_params_size(void) { return (int)sizeof(ScanParams); }

int pinot_fused_scan_batch_size(void) { return (int)sizeof(ScanBatch); }

int pinot_device_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

const char* pinot_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
