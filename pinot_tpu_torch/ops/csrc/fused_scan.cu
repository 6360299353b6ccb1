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
// words, each read once, against 3.35 TB/s of HBM (a few bytes a row); and,
// at small group counts, contention of the shared-memory atomics on the few
// hot group slots.
//
// What the design does about that: the TPU kernel's 8-bit limbs, one-hot MXU
// matmuls and int32 super-tiles exist because the TPU lacks fast scatter and
// 64-bit integer ALUs.  An H100 has both, so each thread walks rows in a
// grid-stride loop (coalesced reads of every operand), decodes the key in
// registers (raw code, or lane (w >> bits*l) & mask of a packed word), and
// adds an exact int64 into a block-private [E, G] table in dynamic shared
// memory; rows a mask drops issue no atomic at all.  Each block then flushes
// its non-zero slots into the global int64 table with one atomic each.  When
// E*G*8 bytes exceed the block's shared memory the rows add straight into the
// global table.  The wrapper (ops/fused_scan.py) converts int64 to f64.
//
// Plain C interface for ctypes: every pointer and the stream are void*, and
// pinot_fused_scan returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define PINOT_MAX_ENTRIES 16
#define PINOT_BLOCK 256
#define PINOT_MAX_BLOCKS_PER_SM 4

// element type codes shared with ops/fused_scan.py (_DTYPE_CODES)
enum ElemType {
  T_U8 = 0,
  T_I8 = 1,
  T_I16 = 2,
  T_U16 = 3,
  T_I32 = 4,
  T_U32 = 5,
  T_I64 = 6,
};

enum EntryKind { K_COUNT = 0, K_INT_SUM = 1, K_INT64_SUM = 2 };

struct ScanEntry {
  const void* mask;    // bool[n]
  const void* values;  // [n] of vtype; null for count
  int32_t kind;        // EntryKind
  int32_t vtype;       // ElemType of values
  int32_t n_limbs;     // int_sum: limbs of the plan (1..4); int64_sum: 1..8
  int32_t is_signed;   // int_sum: the plan's sign limb
};

struct ScanParams {
  const void* key;         // codes [n] of key_type, or packed words when key_bits > 0
  const void* mask_words;  // optional uint32[n / 32] filter bitmap
  const void* pred;        // optional codes [n] of pred_type for lo <= c < hi
  int64_t n;
  int32_t key_type;
  int32_t key_bits;        // 0: raw codes; 4 / 8 / 16: lanes in uint32 words
  int32_t pred_type;
  int32_t pred_lo;
  int32_t pred_hi;
  int32_t num_groups;
  int32_t num_entries;
  int32_t pad_;
  ScanEntry e[PINOT_MAX_ENTRIES];
};

__device__ __forceinline__ int64_t load_int(const void* p, int t, int64_t r) {
  switch (t) {
    case T_U8: return ((const uint8_t*)p)[r];
    case T_I8: return ((const int8_t*)p)[r];
    case T_I16: return ((const int16_t*)p)[r];
    case T_U16: return ((const uint16_t*)p)[r];
    case T_I32: return ((const int32_t*)p)[r];
    case T_U32: return ((const uint32_t*)p)[r];
    default: return ((const int64_t*)p)[r];
  }
}

// The value an entry adds for row r, exactly as the Pallas kernel's limbs
// recombine it: int_sum reads the value as int32 (so uint32 wraps), keeps the
// low 8*n_limbs bits of its two's-complement pattern and, with a sign limb,
// subtracts 2^(8*n_limbs) for negatives; int64_sum keeps the low 8*n_limbs
// bits of |v| and puts the sign back.  Inside the plan's value range both
// equal v.
__device__ __forceinline__ uint64_t entry_value(const ScanEntry& en, int64_t r) {
  if (en.kind == K_COUNT) return 1ull;
  if (en.kind == K_INT_SUM) {
    const int32_t x = (int32_t)load_int(en.values, en.vtype, r);
    uint32_t u = (uint32_t)x;
    if (en.n_limbs < 4) u &= (1u << (8 * en.n_limbs)) - 1u;
    int64_t v = (int64_t)u;
    if (en.is_signed && x < 0) v -= (int64_t)1 << (8 * en.n_limbs);
    return (uint64_t)v;
  }
  const int64_t x = ((const int64_t*)en.values)[r];
  const bool neg = x < 0;
  uint64_t a = neg ? 0ull - (uint64_t)x : (uint64_t)x;
  if (en.n_limbs < 8) a &= (1ull << (8 * en.n_limbs)) - 1ull;
  return neg ? 0ull - a : a;
}

template <bool SHARED>
__global__ void __launch_bounds__(PINOT_BLOCK)
fused_scan_kernel(const ScanParams p, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  const int G = p.num_groups;
  const int E = p.num_entries;
  unsigned long long* tab = SHARED ? smem : out;
  if (SHARED) {
    for (int i = threadIdx.x; i < E * G; i += blockDim.x) smem[i] = 0ull;
    __syncthreads();
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int lanes = p.key_bits > 0 ? 32 / p.key_bits : 1;
  const uint32_t lane_mask = p.key_bits > 0 ? (1u << p.key_bits) - 1u : 0u;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < p.n; r += stride) {
    int64_t code;
    if (p.key_bits > 0) {
      const uint32_t w = ((const uint32_t*)p.key)[r / lanes];
      code = (w >> (p.key_bits * (int)(r % lanes))) & lane_mask;
    } else {
      code = load_int(p.key, p.key_type, r);
    }
    if (code < 0 || code >= G) continue;  // out-of-table codes drop, as in the TPU kernel
    if (p.mask_words != nullptr &&
        !((((const uint32_t*)p.mask_words)[r >> 5] >> (r & 31)) & 1u))
      continue;
    if (p.pred != nullptr) {
      const int64_t pc = load_int(p.pred, p.pred_type, r);
      if (pc < p.pred_lo || pc >= p.pred_hi) continue;
    }
#pragma unroll
    for (int e = 0; e < PINOT_MAX_ENTRIES; ++e) {
      if (e >= E) break;
      if (!((const uint8_t*)p.e[e].mask)[r]) continue;
      const uint64_t v = entry_value(p.e[e], r);
      if (v != 0ull) atomicAdd(&tab[(int64_t)e * G + code], (unsigned long long)v);
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < E * G; i += blockDim.x) {
      const unsigned long long v = smem[i];
      if (v != 0ull) atomicAdd(&out[i], v);
    }
  }
}

extern "C" {

// out: zeroed int64[num_entries, num_groups] on the current device.
int pinot_fused_scan(const ScanParams* p, void* out, void* stream) {
  if (p->num_entries < 1 || p->num_entries > PINOT_MAX_ENTRIES || p->num_groups < 1 || p->n < 0)
    return (int)cudaErrorInvalidValue;
  if (p->n == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = (size_t)p->num_entries * (size_t)p->num_groups * sizeof(unsigned long long);
  const bool shared = smem <= (size_t)smem_optin;
  int per_sm = PINOT_MAX_BLOCKS_PER_SM;
  if (shared) {
    err = cudaFuncSetAttribute(fused_scan_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int fit = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, fused_scan_kernel<true>,
                                                        PINOT_BLOCK, smem);
    if (err != cudaSuccess) return (int)err;
    if (fit < per_sm) per_sm = fit;
    if (per_sm < 1) per_sm = 1;
  }
  const int64_t need = (p->n + PINOT_BLOCK - 1) / PINOT_BLOCK;
  int64_t grid = (int64_t)sms * per_sm;
  if (grid > need) grid = need;
  if (grid < 1) grid = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (shared) {
    fused_scan_kernel<true><<<(unsigned)grid, PINOT_BLOCK, smem, s>>>(
        *p, (unsigned long long*)out);
  } else {
    fused_scan_kernel<false><<<(unsigned)grid, PINOT_BLOCK, 0, s>>>(
        *p, (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}

int pinot_fused_scan_params_size(void) { return (int)sizeof(ScanParams); }

const char* pinot_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
