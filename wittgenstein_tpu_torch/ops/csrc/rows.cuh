// rows.cuh: what the packed-row kernels share — the row map of broadcast
// operands, 16-byte loads, the word combinators and the launch geometry.
//
// A row kernel sees its operands as M rows of w words over a broadcast
// leading shape.  The row map gives that shape (at most kMaxRank dims,
// innermost last, adjacent dims already merged by the wrapper) and each
// operand's stride in words per dim: 0 where the operand broadcasts, so a
// broadcast or sliced operand is read in place and never copied dense.
// Rank 0 is the common case of one leading dim after merging: row r sits
// at r * sa[0] and r * sb[0], with no division.  The last (word) axis is
// contiguous in every operand.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

constexpr int kMaxRank = 6;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;  // grid-stride beyond ~60 blocks per SM

enum { OP_NONE = 0, OP_AND = 1, OP_OR = 2, OP_ANDNOT = 3 };

struct RowMap {
  int rank;
  unsigned shape[kMaxRank];
  long long sa[kMaxRank];  // operand a's row strides, in words
  long long sb[kMaxRank];  // operand b's row strides, in words
};

// The host packs a map as int64 [m, rank, shape[6], sa[6], sb[6]].
static inline RowMap unpack_map(const long long* packed, long long* m) {
  RowMap map;
  *m = packed[0];
  map.rank = (int)packed[1];
  for (int d = 0; d < kMaxRank; ++d) {
    map.shape[d] = (unsigned)packed[2 + d];
    map.sa[d] = packed[2 + kMaxRank + d];
    map.sb[d] = packed[2 + 2 * kMaxRank + d];
  }
  return map;
}

// 16-byte loads need w % 4 == 0, every row start on a 16-byte boundary
// (strides in words divisible by 4) and 16-byte-aligned base pointers.
static inline bool map_takes_vec4(const RowMap& map, const void* a, const void* b, int w) {
  if (w % 4 != 0 || ((uintptr_t)a & 15) != 0 || (b && ((uintptr_t)b & 15) != 0)) return false;
  for (int d = 0; d < (map.rank > 0 ? map.rank : 1); ++d)
    if (map.sa[d] % 4 != 0 || map.sb[d] % 4 != 0) return false;
  return true;
}

// Row `row` of the broadcast shape -> word offsets of its rows in a and b.
// The loop is unrolled over kMaxRank so the map stays in parameter space.
__device__ __forceinline__ void row_offsets(const RowMap& map, unsigned row,
                                            long long& oa, long long& ob) {
  if (map.rank == 0) {
    oa = (long long)row * map.sa[0];
    ob = (long long)row * map.sb[0];
    return;
  }
  oa = 0;
  ob = 0;
#pragma unroll
  for (int d = kMaxRank - 1; d >= 0; --d) {
    if (d < map.rank) {
      const unsigned s = map.shape[d];
      const unsigned i = row % s;
      row /= s;
      oa += (long long)i * map.sa[d];
      ob += (long long)i * map.sb[d];
    }
  }
}

template <int OP>
__device__ __forceinline__ uint32_t combine(uint32_t a, uint32_t b) {
  if constexpr (OP == OP_AND) return a & b;
  if constexpr (OP == OP_OR) return a | b;
  if constexpr (OP == OP_ANDNOT) return a & ~b;
  return a;
}

// VEC consecutive words at p (VEC = 4: one 16-byte load).
template <int VEC>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

// Sum over the TPR lanes of a row group (TPR a power of two, at most 32).
template <int TPR>
__device__ __forceinline__ int group_sum(int x) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, TPR);
  return x;
}

// The lanes of this lane's row group, as a warp mask.
template <int TPR>
__device__ __forceinline__ unsigned group_lanes(int lane) {
  return TPR == 32 ? 0xffffffffu : ((1u << TPR) - 1u) << (lane - lane % TPR);
}

// Lanes per row: the largest power of two <= min(32, units per row), so a
// warp step reads 32 consecutive units of a row or 32/TPR whole rows.
static inline int lanes_per_row(long long units) {
  int t = 1;
  while (t < 32 && 2 * t <= units) t *= 2;
  return t;
}

static inline unsigned grid_for(long long lanes) {
  long long blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return (unsigned)blocks;
}

// Calls f(std::integral_constant<int, TPR>) for a runtime TPR in {1..32}.
template <typename F>
static inline void with_tpr(int tpr, F f) {
  switch (tpr) {
    case 32: f(std::integral_constant<int, 32>()); break;
    case 16: f(std::integral_constant<int, 16>()); break;
    case 8: f(std::integral_constant<int, 8>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 2: f(std::integral_constant<int, 2>()); break;
    default: f(std::integral_constant<int, 1>()); break;
  }
}
