// The popcount_words family: set bits of packed rows, three forms of one
// design.
//
//   witt_popcount_words(x)           [M, w] uint32 -> [M] int32
//   witt_popcount_binop(a, b, op)    popcount(a op b) per row, op in
//                                    {AND, OR, ANDNOT = a & ~b}, a and b
//                                    broadcast over the leading axes
//   witt_cand_score(sig, inc, ind, agg)
//                                    Handel's candidate score: per
//                                    candidate row of sig [M, K, w] against
//                                    its node's rows inc/ind/agg [M, w],
//                                    s = sizeIfIncluded, card = |sig|,
//                                    wind = |sig | ind|, aggi = [sig & agg != 0]
//
// Replaces the TPU kernel popcount_words_pallas / _popcount_kernel in
// wittgenstein_tpu/ops/bitops_pallas.py (SWAR count per word, then a row
// sum over a row block held whole in VMEM).  The TPU caller composes the
// operands (a & b, the candidate-score where/or chain) in elementwise
// passes that write each operand to memory before the kernel reads it;
// here the combination happens in registers, so a fused form reads its
// inputs once and writes only the counts.
//
// Bound on the H100: bytes.  Each word costs a few logic ops and __popc,
// far below the card's integer rate, so a form can at best stream its
// inputs from HBM once.  The design:
//   * a group of TPR lanes (a power of two, at most 32) shares one row and
//     strides over it, so a warp step reads 32 consecutive units — whole
//     narrow rows, or one slice of a wide row — and the group sums with
//     warp shuffles;
//   * a unit is one 16-byte load (4 words) wherever the row width is a
//     multiple of 4 and every row starts on a 16-byte boundary, else one
//     word;
//   * rows of 1 or 2 words (contiguous, aligned): one thread takes the 4 or
//     2 whole rows of one 16-byte load and writes their counts together;
//   * cand_score: a row group takes one candidate row and its node's
//     inc/ind/agg rows, and makes in one pass three counts (|sig|,
//     |sig | ind|, |sig | inc | ind|) and two tests (sig meets inc, sig
//     meets agg: an OR of words and a group ballot, no count); s is
//     |sig | ind| when sig meets inc, else |sig | inc | ind| — the where/or
//     chain of the composed form.  The K row groups of a node sit side by
//     side in one block, so its rows come from HBM once and from L1 for
//     the rest, and all M * K rows are in flight at once (a row group per
//     node streaming its K rows in turn leaves narrow rows latency-bound).
//     Three __popc per word keep it under the card's __popc throughput
//     (16 per SM per clock) at the bytes bound.
// A grid-stride loop over warp steps covers any M; its bound depends on
// the warp only, so the full-mask shuffles stay legal on a ragged M.
#include "rows.cuh"

template <int OP, int VEC, int TPR>
__global__ void popcount_rows(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                              int32_t* __restrict__ out, RowMap map, long long m, int w) {
  constexpr int kRowsPerWarp = 32 / TPR;
  const int lane = threadIdx.x & 31;
  const int sub = lane % TPR;
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (gridDim.x * (long long)blockDim.x) >> 5;
  for (long long base = warp * kRowsPerWarp; base < m; base += n_warps * kRowsPerWarp) {
    const long long row = base + lane / TPR;
    int c = 0;
    if (row < m) {
      long long oa, ob;
      row_offsets(map, (unsigned)row, oa, ob);
#pragma unroll 4
      for (int j = sub * VEC; j < w; j += TPR * VEC) {
        uint32_t x[VEC], y[VEC] = {};
        load_words<VEC>(a + oa + j, x);
        if constexpr (OP != OP_NONE) load_words<VEC>(b + ob + j, y);
#pragma unroll
        for (int i = 0; i < VEC; ++i) c += __popc(combine<OP>(x[i], y[i]));
      }
    }
    c = group_sum<TPR>(c);
    if (row < m && sub == 0) out[row] = c;
  }
}

// Rows of W = 1 or 2 words: one 16-byte load holds 4 / W whole rows.
template <int W>
__global__ void popcount_narrow(const uint32_t* __restrict__ x, int32_t* __restrict__ out,
                                long long m) {
  constexpr int kRows = 4 / W;
  const long long nvec = m / kRows;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = gridDim.x * (long long)blockDim.x;
  for (long long v = tid; v < nvec; v += stride) {
    uint32_t q[4];
    load_words<4>(x + 4 * v, q);
    if constexpr (W == 1)
      reinterpret_cast<int4*>(out)[v] =
          make_int4(__popc(q[0]), __popc(q[1]), __popc(q[2]), __popc(q[3]));
    else
      reinterpret_cast<int2*>(out)[v] =
          make_int2(__popc(q[0]) + __popc(q[1]), __popc(q[2]) + __popc(q[3]));
  }
  const long long row = nvec * kRows + tid;  // the rows after the last whole load
  if (row < m) {
    int c = 0;
    for (int j = 0; j < W; ++j) c += __popc(__ldg(x + row * W + j));
    out[row] = c;
  }
}

// One row group per candidate row, which reads its node's rows beside its
// own: the K row groups of a node are neighbours in one block, so the node
// rows come from HBM once and from L1 after.
template <int VEC, int TPR>
__global__ void cand_score_rows(const uint32_t* __restrict__ sig, const uint32_t* __restrict__ inc,
                                const uint32_t* __restrict__ ind, const uint32_t* __restrict__ agg,
                                int32_t* __restrict__ s_out, int32_t* __restrict__ card_out,
                                int32_t* __restrict__ wind_out, int32_t* __restrict__ aggi_out,
                                long long rows, int k, int w) {
  constexpr int kRowsPerWarp = 32 / TPR;
  const int lane = threadIdx.x & 31;
  const int sub = lane % TPR;
  const unsigned group = group_lanes<TPR>(lane);
  const long long warp = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = (gridDim.x * (long long)blockDim.x) >> 5;
  for (long long base = warp * kRowsPerWarp; base < rows; base += n_warps * kRowsPerWarp) {
    const long long row = base + lane / TPR;
    // sig meets inc and sig meets agg are tests, so they OR words; only
    // the three sizes pay a __popc per word
    uint32_t meet_inc = 0u, meet_agg = 0u;
    int n_wind = 0, n_all = 0, n_card = 0;
    if (row < rows) {
      const long long node = (unsigned)row / (unsigned)k;
      const uint32_t* q = sig + row * w;
#pragma unroll 2
      for (int j = sub * VEC; j < w; j += TPR * VEC) {
        uint32_t x[VEC], vi[VEC], vd[VEC], vg[VEC] = {};
        load_words<VEC>(q + j, x);
        load_words<VEC>(inc + node * w + j, vi);
        load_words<VEC>(ind + node * w + j, vd);
        if (agg) load_words<VEC>(agg + node * w + j, vg);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          meet_inc |= x[i] & vi[i];
          meet_agg |= x[i] & vg[i];
          n_wind += __popc(x[i] | vd[i]);
          n_all += __popc(x[i] | vi[i] | vd[i]);
          n_card += __popc(x[i]);
        }
      }
    }
    const bool inter = (__ballot_sync(0xffffffffu, meet_inc != 0u) & group) != 0u;
    const bool aggi = (__ballot_sync(0xffffffffu, meet_agg != 0u) & group) != 0u;
    n_wind = group_sum<TPR>(n_wind);
    n_all = group_sum<TPR>(n_all);
    n_card = group_sum<TPR>(n_card);
    if (row < rows && sub == 0) {
      s_out[row] = inter ? n_wind : n_all;
      card_out[row] = n_card;
      wind_out[row] = n_wind;
      if (aggi_out) aggi_out[row] = aggi;
    }
  }
}

template <int OP>
static void launch_rows(bool vec4, const uint32_t* a, const uint32_t* b, int32_t* out,
                        const RowMap& map, long long m, int w, cudaStream_t stream) {
  with_tpr(lanes_per_row(vec4 ? w / 4 : w), [&](auto t) {
    constexpr int TPR = decltype(t)::value;
    const unsigned grid = grid_for(m * TPR);
    if (vec4)
      popcount_rows<OP, 4, TPR><<<grid, kThreads, 0, stream>>>(a, b, out, map, m, w);
    else
      popcount_rows<OP, 1, TPR><<<grid, kThreads, 0, stream>>>(a, b, out, map, m, w);
  });
}

extern "C" int witt_popcount_words(const void* words, void* out, long long m, int w,
                                   void* stream) {
  const uint32_t* x = static_cast<const uint32_t*>(words);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m == 0) return 0;
  const bool aligned = ((uintptr_t)words & 15) == 0 && ((uintptr_t)out & 15) == 0;
  if (aligned && w == 1) {
    popcount_narrow<1><<<grid_for(m / 4 + 1), kThreads, 0, s>>>(x, o, m);
  } else if (aligned && w == 2) {
    popcount_narrow<2><<<grid_for(m / 2 + 1), kThreads, 0, s>>>(x, o, m);
  } else {
    RowMap map = {};  // rank 0: contiguous rows of w words
    map.sa[0] = w;
    launch_rows<OP_NONE>(map_takes_vec4(map, words, nullptr, w), x, nullptr, o, map, m, w, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int witt_popcount_binop(const void* a, const void* b, void* out,
                                   const long long* packed_map, int w, int op, void* stream) {
  long long m;
  const RowMap map = unpack_map(packed_map, &m);
  if (m == 0) return 0;
  const uint32_t* pa = static_cast<const uint32_t*>(a);
  const uint32_t* pb = static_cast<const uint32_t*>(b);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = map_takes_vec4(map, a, b, w);
  switch (op) {
    case OP_AND: launch_rows<OP_AND>(vec4, pa, pb, o, map, m, w, s); break;
    case OP_OR: launch_rows<OP_OR>(vec4, pa, pb, o, map, m, w, s); break;
    case OP_ANDNOT: launch_rows<OP_ANDNOT>(vec4, pa, pb, o, map, m, w, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int witt_cand_score(const void* sig, const void* inc, const void* ind, const void* agg,
                               void* s, void* card, void* wind, void* aggi, long long m, int k,
                               int w, void* stream) {
  const long long rows = m * k;
  if (rows == 0) return 0;
  const uint32_t* in[4] = {static_cast<const uint32_t*>(sig), static_cast<const uint32_t*>(inc),
                           static_cast<const uint32_t*>(ind), static_cast<const uint32_t*>(agg)};
  int32_t* out[4] = {static_cast<int32_t*>(s), static_cast<int32_t*>(card),
                     static_cast<int32_t*>(wind), static_cast<int32_t*>(aggi)};
  bool vec4 = w % 4 == 0;
  for (int i = 0; i < 4; ++i) vec4 = vec4 && ((uintptr_t)in[i] & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  with_tpr(lanes_per_row(vec4 ? w / 4 : w), [&](auto t) {
    constexpr int TPR = decltype(t)::value;
    const unsigned grid = grid_for(rows * TPR);
    if (vec4)
      cand_score_rows<4, TPR><<<grid, kThreads, 0, st>>>(in[0], in[1], in[2], in[3], out[0],
                                                         out[1], out[2], out[3], rows, k, w);
    else
      cand_score_rows<1, TPR><<<grid, kThreads, 0, st>>>(in[0], in[1], in[2], in[3], out[0],
                                                         out[1], out[2], out[3], rows, k, w);
  });
  return (int)cudaGetLastError();
}
