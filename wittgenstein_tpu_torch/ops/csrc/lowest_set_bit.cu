// lowest_set_bit: index of the lowest set bit of each packed row, two forms
// of one kernel.
//
//   witt_lowest_set_bit(x)            [M, w] uint32 -> [M] int32
//   witt_lowest_set_bit_andnot(a, b)  rows of a & ~b, a and b broadcast over
//                                     the leading axes -> (has [M] bool,
//                                     lowest [M] int32)
//
// An empty row yields 32, the value the JAX package's lax path gives (its
// argmax lands on word 0, whose (0 & -0)-1 has 32 bits set).  Bit 32 is a
// real bit of a row of two or more words, so `has` is its own output and is
// not read back from `lowest`.
//
// Replaces the TPU kernel lowest_set_bit_pallas / _lowest_kernel in
// wittgenstein_tpu/ops/bitops_pallas.py, which builds a per-word candidate
// (SWAR popcount of low-1) and takes a min over the row.  Its Handel caller
// forms a & ~b in two elementwise passes and counts the row's bits in a
// third to gate the pick; the andnot form does all of it in one pass.
//
// Bound on the H100: bytes, up to each row's first nonzero word.  A group
// of TPR lanes shares a row (the layout of popcount_words.cu) and walks it
// in warp steps of TPR units — 16-byte loads where the row width is a
// multiple of 4 and every row starts on a 16-byte boundary, else words.
// Each lane keeps the first nonzero word of its unit, __ballot_sync over
// the group finds the lowest lane that has one (lanes ascend over the
// row's words), and __ffs on that word gives the bit; the warp leaves the
// row walk at the first step where every group has found its bit.  Rows
// of fewer than two units take one lane each, which walks its row alone
// with no collective.
#include "rows.cuh"

template <bool ANDNOT, int VEC, int TPR>
__global__ void lowest_rows(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                            uint8_t* __restrict__ has, int32_t* __restrict__ low, RowMap map,
                            long long m, int w) {
  constexpr int kRowsPerWarp = 32 / TPR;
  const int lane = threadIdx.x & 31;
  const int sub = lane % TPR;
  const unsigned group = group_lanes<TPR>(lane);
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (gridDim.x * (long long)blockDim.x) >> 5;
  for (long long base = warp * kRowsPerWarp; base < m; base += n_warps * kRowsPerWarp) {
    const long long row = base + lane / TPR;
    const bool live = row < m;
    long long oa = 0, ob = 0;
    if (live) row_offsets(map, (unsigned)row, oa, ob);
    int best = 32;  // an empty row's answer
    bool hit = false;
    if constexpr (TPR == 1) {
      // a lane per row: it walks its row alone, no group to agree with
      for (int j = 0; live && !hit && j < w; j += VEC) {
        uint32_t x[VEC], y[VEC] = {};
        load_words<VEC>(a + oa + j, x);
        if constexpr (ANDNOT) load_words<VEC>(b + ob + j, y);
#pragma unroll
        for (int i = VEC - 1; i >= 0; --i) {
          const uint32_t e = ANDNOT ? (x[i] & ~y[i]) : x[i];
          if (e != 0u) {
            best = 32 * (j + i) + __ffs((int)e) - 1;
            hit = true;
          }
        }
      }
    } else {
      // the loop bound is the same for every lane, so the full-mask
      // collectives stay legal; a done group only stops loading
      bool done = !live;
      for (int j0 = 0; j0 < w; j0 += TPR * VEC) {
        const int j = j0 + sub * VEC;
        int cand = 0;
        bool nz = false;
        if (!done && j < w) {
          uint32_t x[VEC], y[VEC] = {};
          load_words<VEC>(a + oa + j, x);
          if constexpr (ANDNOT) load_words<VEC>(b + ob + j, y);
#pragma unroll
          for (int i = VEC - 1; i >= 0; --i) {  // the lowest nonzero word wins
            const uint32_t e = ANDNOT ? (x[i] & ~y[i]) : x[i];
            if (e != 0u) {
              cand = 32 * (j + i) + __ffs((int)e) - 1;
              nz = true;
            }
          }
        }
        const unsigned hits = __ballot_sync(0xffffffffu, nz) & group;
        const int got = __shfl_sync(0xffffffffu, cand, hits ? __ffs((int)hits) - 1 : lane);
        if (!done && hits) {
          best = got;
          hit = true;
          done = true;
        }
        if (__all_sync(0xffffffffu, done)) break;
      }
    }
    if (live && sub == 0) {
      low[row] = best;
      if constexpr (ANDNOT) has[row] = hit;
    }
  }
}

template <bool ANDNOT>
static void launch(const uint32_t* a, const uint32_t* b, uint8_t* has, int32_t* low,
                   const RowMap& map, long long m, int w, cudaStream_t stream) {
  const bool vec4 = map_takes_vec4(map, a, b, w);
  with_tpr(lanes_per_row(vec4 ? w / 4 : w), [&](auto t) {
    constexpr int TPR = decltype(t)::value;
    const unsigned grid = grid_for(m * TPR);
    if (vec4)
      lowest_rows<ANDNOT, 4, TPR><<<grid, kThreads, 0, stream>>>(a, b, has, low, map, m, w);
    else
      lowest_rows<ANDNOT, 1, TPR><<<grid, kThreads, 0, stream>>>(a, b, has, low, map, m, w);
  });
}

extern "C" int witt_lowest_set_bit(const void* words, void* out, long long m, int w,
                                   void* stream) {
  if (m == 0) return 0;
  RowMap map = {};  // rank 0: contiguous rows of w words
  map.sa[0] = w;
  launch<false>(static_cast<const uint32_t*>(words), nullptr, nullptr,
                static_cast<int32_t*>(out), map, m, w, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

extern "C" int witt_lowest_set_bit_andnot(const void* a, const void* b, void* has, void* low,
                                          const long long* packed_map, int w, void* stream) {
  long long m;
  const RowMap map = unpack_map(packed_map, &m);
  if (m == 0) return 0;
  launch<true>(static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
               static_cast<uint8_t*>(has), static_cast<int32_t*>(low), map, m, w,
               static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
